"""The port's async file I/O (``ops/aio``, the host op ``ops/csrc/aio.cpp``):
a round trip with byte offsets and tickets (as the JAX package's
``test_aio_roundtrip_with_offsets``), reads of the JAX handle's files, the
O_DIRECT probe and aligned buffers, and failures as ``IOError``."""

import os

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.aio import AioHandle as JaxAioHandle
from deepspeed_tpu_torch.ops.aio import (AioHandle, aligned_array,
                                         o_direct_supported)

from _torch_threads import one_thread  # noqa: F401


def test_roundtrip_with_offsets_and_tickets(tmp_path):
    h = AioHandle(num_threads=3, block_size=4096)
    path = str(tmp_path / "blob.bin")
    a = torch.arange(1024, dtype=torch.float32)
    b = torch.arange(1024, 2048, dtype=torch.float32)
    h.async_pwrite(a, path, offset=0)
    h.async_pwrite(b, path, offset=a.numel() * 4)
    assert h.wait() == 0 and h.pending() == 0
    out = torch.empty(2048)
    t1 = h.async_pread(out[:1024], path, offset=0)
    t2 = h.async_pread(out[1024:], path, offset=4096)
    assert t1 != t2
    h.wait_ticket(t2)
    h.wait_ticket(t1)
    assert torch.equal(out, torch.arange(2048, dtype=torch.float32))
    # the JAX handle reads the port's file and the port reads the JAX one
    jh = JaxAioHandle(num_threads=2)
    back = np.empty(2048, np.float32)
    jh.async_pread(back, path)
    jh.wait()
    np.testing.assert_array_equal(back, out.numpy())
    jpath = str(tmp_path / "jax.bin")
    jh.async_pwrite(np.arange(10, dtype=np.float32) * 3, jpath)
    jh.wait()
    jh.close()
    mine = torch.empty(10)
    h.sync_pread(mine, jpath)
    assert torch.equal(mine, torch.arange(10, dtype=torch.float32) * 3)
    h.close()


def test_aligned_buffers_take_o_direct_where_the_filesystem_does(tmp_path):
    buf = aligned_array(3 * 4096 + 8, torch.float32)
    assert buf.data_ptr() % 4096 == 0 and buf.numel() == 3 * 1024 + 2
    supported = o_direct_supported(str(tmp_path))
    assert isinstance(supported, bool)
    print(f"O_DIRECT on {tmp_path}: {supported}")
    h = AioHandle(num_threads=2, block_size=8192, o_direct=supported)
    src = aligned_array(16384, torch.float32)
    src.copy_(torch.arange(4096, dtype=torch.float32))
    path = str(tmp_path / "direct.bin")
    h.sync_pwrite(src, path)
    dst = aligned_array(16384, torch.float32)
    h.sync_pread(dst, path)
    assert torch.equal(src, dst) and os.path.getsize(path) == 16384
    h.close()


def test_a_failed_chunk_raises_ioerror(tmp_path):
    h = AioHandle(num_threads=1)
    with pytest.raises(IOError):
        h.sync_pwrite(torch.ones(16), str(tmp_path / "missing" / "x.bin"))
    h.async_pread(torch.empty(16), str(tmp_path / "absent.bin"))
    with pytest.raises(IOError):
        h.wait()
    with pytest.raises(ValueError, match="block_size"):
        AioHandle(block_size=1024)
    with pytest.raises(ValueError, match="contiguous CPU"):
        h.async_pwrite(torch.ones(4, 4).t(), str(tmp_path / "y.bin"))
    h.close()
