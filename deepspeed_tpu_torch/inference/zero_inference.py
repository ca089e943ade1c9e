"""ZeRO-Inference: weight streaming for models larger than device memory
(port of ``deepspeed_tpu/inference/zero_inference.py``).

The model's weights live in HOST memory (pinned, or an ``np.memmap`` of a
checkpoint) and stream to the card one transformer layer at a time, so the
device holds the small resident pieces (embeddings, final norm, head), a
few layers and the activations, not the model. Throughput-oriented by
design: with a large token batch each layer's products amortize its
transfer.

The torch mechanics (the JAX engine leans on async dispatch instead):

* each layer is packed (``utils/streaming.LayerWireFormat``) into one of
  ``prefetch + 2`` rotating pinned staging buffers and copied, on a
  dedicated ``torch.cuda.Stream`` with ``non_blocking=True``, into the
  device buffer of the same slot; an event marks the copy done, and the
  compute stream waits on it before the layer runs;
* a staging buffer is overwritten only after its last copy's event has
  completed (the host waits on it; the JAX ``_staging_dev`` guard), and a
  device buffer only after the compute that read it (the copy stream waits
  on an event the compute stream records), so the device holds exactly
  ``prefetch + 2`` layer buffers;
* one ``TransformerBlock`` built on the ``meta`` device runs every layer
  through ``torch.func.functional_call`` over views into the layer's
  device buffer: fresh attention takes the flash kernel (the model's
  ``_use_flash`` rule), a cached one-token decode the decode kernel, and
  the int8 tier's projections ``int8_matmul``.

On the CPU route a copy to the "device" would alias the staging buffer the
next layers rotate through (the hazard the JAX engine names), so each
layer gets a private copy there.

``params_host`` is the port's ``TransformerLM`` state dict: tensors or
numpy arrays (``np.memmap`` views included). With ``int8=True`` the
projections are quantized on the host to the ``QuantDense`` layout
(``ops.quantization.convert.quantize_lm_state_dict``) and each streamed
layer is about half the bytes; the head stays full precision unless the
config's ``int8_head``. The head projects in fp32 (tied or untied), as the
JAX engine's ``head_fn`` does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..accelerator import resolve_device
from ..models.transformer_lm import (KVCacheSpec, TransformerBlock,
                                     TransformerConfig, TransformerLM,
                                     alibi_slopes)
from ..ops.quantization.convert import DENSE_KEYS, quantize_lm_state_dict
from ..ops.quantization.linear import QuantDense
from ..parallel import mesh as mesh_mod
from ..utils.logging import log_dist
from ..utils.streaming import LayerWireFormat, host_tensor

_BLOCK = "blocks."


class ZeroInferenceEngine:
    """Full-context scoring and generation with layer-streamed weights
    (module docstring). ``dtype`` defaults to the config's; ``device`` to
    ``cuda``."""

    def __init__(self, config: TransformerConfig, params_host: Dict[str, Any],
                 dtype: Optional[torch.dtype] = None, prefetch: int = 1,
                 pack: bool = True, int8: bool = False,
                 device: Any = None):
        if mesh_mod.has_mesh() and \
                mesh_mod.get_model_parallel_world_size() > 1:
            raise NotImplementedError(
                "ZeRO-Inference over a model group above one rank: it "
                "streams whole layers to one card, as the JAX package's "
                "ZeroInferenceEngine streams to one device (jax.device_put "
                "with no sharding); run it on one rank")
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        host = {k: host_tensor(v) for k, v in params_host.items()}
        params = host
        if int8 and not config.int8_weights:
            head = set() if config.int8_head else {"lm_head"}
            params, n_dense = quantize_lm_state_dict(host, DENSE_KEYS - head)
            config = dataclasses.replace(config, int8_weights=True)
            log_dist(f"ZeroInference int8 tier: {n_dense} linear weights -> "
                     f"QuantDense layout (streamed int8-at-rest)", ranks=[0])
        if self._cuda:
            # pinned host weights (the pack reads them, pack=False copies
            # them straight over); a memmap stays a memmap
            params = {k: v if isinstance(params_host.get(k), np.memmap)
                      and v is host[k] else v.pin_memory()
                      for k, v in params.items()}
        self.dtype = dtype or config.dtype
        self.config = config
        self.n_layer = config.n_layer
        self.prefetch = max(0, int(prefetch))
        self.pack = pack
        self._layers = [{k[len(prefix):]: v for k, v in params.items()
                         if k.startswith(prefix)}
                        for prefix in (f"{_BLOCK}{i}." for i in
                                       range(self.n_layer))]
        # the wire format: floats in the compute dtype but the int8 tier's
        # per-channel scales
        self._wire = LayerWireFormat(
            self._layers[0], self.dtype,
            keep_dtype=lambda name, leaf: name.endswith(".scale"))
        cfg = dataclasses.replace(config, dtype=self.dtype)
        self._block = TransformerBlock(cfg, dtype=cfg.dtype, device="meta")
        if cfg.pos_emb == "alibi":
            self._block.attn.alibi = alibi_slopes(cfg.n_head).to(self.device)
        # the always-resident pieces: embeddings, final norm, head
        self._small = TransformerLM(dataclasses.replace(cfg, n_layer=0),
                                    device="meta").to_empty(
                                        device=self.device)
        self._small.load_state_dict({k: v for k, v in params.items()
                                     if not k.startswith(_BLOCK)})
        self._small.eval()
        self._spec = KVCacheSpec(n_layer=self.n_layer,
                                 kv_heads=cfg.kv_heads,
                                 head_dim=cfg.head_dim, dtype=self.dtype,
                                 max_seq_len=cfg.max_seq_len,
                                 quant=cfg.kv_cache_quant)
        n_buf = self.prefetch + 2
        nbytes = self._wire.total_nbytes
        self._staging = [torch.empty(nbytes, dtype=torch.uint8,
                                     pin_memory=self._cuda)
                         for _ in range(n_buf)]
        self._slot = 0
        if self._cuda:
            self._dev = [torch.empty(nbytes, dtype=torch.uint8,
                                     device=self.device)
                         for _ in range(n_buf)]
            self._copy_stream = torch.cuda.Stream(self.device)
            self._copied = [torch.cuda.Event() for _ in range(n_buf)]
            self._used = [torch.cuda.Event() for _ in range(n_buf)]
        self.layer_nbytes = nbytes
        self.streamed_bytes = 0
        total = sum(v.numel() * v.element_size() for v in params.values())
        log_dist(f"ZeroInference: {total / 1e9:.2f} GB weights "
                 f"host-resident, streaming {nbytes / 1e6:.1f} MB/layer "
                 f"(prefetch={self.prefetch}, pack={pack}, "
                 f"device={self.device})", ranks=[0])

    # ------------------------------------------------------------------
    # the stream
    # ------------------------------------------------------------------
    def _put_layer(self, i: int):
        """Stage layer ``i`` and start its copy: returns the slot (on the
        card) or the layer's private buffer (CPU)."""
        slot = self._slot
        self._slot = (slot + 1) % len(self._staging)
        layer = self._layers[i]
        self.streamed_bytes += self.layer_nbytes
        if not self._cuda:
            buf = self._staging[slot]
            self._wire.pack_into(layer, buf)
            return buf.clone()
        stream = self._copy_stream
        if self.pack:
            # the staging buffer's previous copy must have landed
            self._copied[slot].synchronize()
            self._wire.pack_into(layer, self._staging[slot])
        with torch.cuda.stream(stream):
            # the device buffer's previous layer must have been computed
            stream.wait_event(self._used[slot])
            if self.pack:
                self._dev[slot].copy_(self._staging[slot], non_blocking=True)
            else:           # one copy a leaf, from the pinned host weights
                dst = self._wire.unpack(self._dev[slot])
                for name, leaf in layer.items():
                    dst[name].copy_(leaf, non_blocking=True)
            self._copied[slot].record(stream)
        return slot

    def _weights(self, staged) -> Dict[str, torch.Tensor]:
        """The layer's leaves as views of its device buffer (on the card,
        after making the compute stream wait for its copy)."""
        if not self._cuda:
            buf = staged
        else:
            torch.cuda.current_stream().wait_event(self._copied[staged])
            buf = self._dev[staged]
        uni = self._wire.uniform_dtype
        if uni is not None:
            return self._wire.unpack_typed(buf.view(uni))
        return self._wire.unpack(buf)

    def _release(self, staged) -> None:
        if self._cuda:
            self._used[staged].record(torch.cuda.current_stream())

    def _stream_pass(self, x, run_layer, layer_times=None):
        """Every layer in turn, ``prefetch`` layers' copies ahead of the
        compute: ``x = run_layer(i, weights, x)``."""
        buffers = {j: self._put_layer(j)
                   for j in range(min(self.prefetch + 1, self.n_layer))}
        for i in range(self.n_layer):
            t0 = time.perf_counter()
            staged = buffers.pop(i)
            nxt = i + self.prefetch + 1
            if nxt < self.n_layer:
                buffers[nxt] = self._put_layer(nxt)
            x = run_layer(i, self._weights(staged), x)
            self._release(staged)
            if layer_times is not None:
                self._sync()
                layer_times.append(time.perf_counter() - t0)
        return x

    def _sync(self) -> None:
        if self._cuda:
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def _ids(self, input_ids) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(input_ids) if not
                              torch.is_tensor(input_ids) else input_ids)
        ids = ids.to(self.device, torch.long)
        return ids[None] if ids.dim() == 1 else ids

    def _head(self, x) -> torch.Tensor:
        """ln_f, then the vocabulary projection in fp32 (JAX ``head_fn``;
        an int8 head is dequantized first)."""
        small = self._small
        x = small.ln_f(x).float()
        if self.config.tie_word_embeddings:
            return F.linear(x, small.embed_tokens.weight.float())
        head = small.lm_head
        if isinstance(head, QuantDense):
            return F.linear(x, head.weight.float() * head.scale[:, None])
        return F.linear(x, head.weight.float())

    @torch.no_grad()
    def forward(self, input_ids, layer_times: Optional[list] = None
                ) -> torch.Tensor:
        """Full-context (B, T, V) fp32 logits with layer streaming.
        ``layer_times``: when given, each layer's stage + copy + compute
        wall seconds are appended (it synchronizes per layer: pass it only
        when measuring)."""
        ids = self._ids(input_ids)
        B, T = ids.shape
        positions = self._small._positions(B, T)
        x = self._small._embed(ids, positions)
        if layer_times is not None:
            self._sync()
        x = self._stream_pass(
            x, lambda i, w, x: functional_call(self._block, w,
                                               (x, positions)),
            layer_times)
        return self._head(x)

    __call__ = forward

    def score(self, input_ids) -> np.ndarray:
        """Per-sequence mean log-likelihood of ``input_ids`` (B, T): the
        scoring mode of ZeRO-Inference."""
        ids = self._ids(input_ids)
        return self.score_logits(self.forward(ids), ids)

    @torch.no_grad()
    def score_logits(self, logits, input_ids) -> np.ndarray:
        """The scoring tail over computed logits: the mean over positions
        of each next token's log-probability, (B,) on the host."""
        ids = self._ids(input_ids)
        # the whole logits: a slice first would copy them
        logp = torch.log_softmax(logits.float(), dim=-1)[:, :-1]
        token_ll = logp.gather(-1, ids[:, 1:, None])[..., 0]
        return token_ll.mean(dim=-1).cpu().numpy()

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0) -> np.ndarray:
        """Autoregressive generation under weight streaming: the weights
        restream through the card at every step, while each layer's KV
        cache stays on the device across the generation (the prefill pass
        builds them, each decode pass writes its position). ``temperature``
        0 is greedy. Returns int32 (B, T_prompt + max_new_tokens)."""
        ids = self._ids(input_ids)
        B, T = ids.shape
        if max_new_tokens <= 0:
            return ids.cpu().numpy().astype(np.int32)
        if T + max_new_tokens > self.config.max_seq_len:
            raise ValueError(f"prompt({T}) + max_new_tokens"
                             f"({max_new_tokens}) exceeds max_seq_len"
                             f"({self.config.max_seq_len})")
        cache = self._spec.stacked_cache(B, self.device)
        rows = torch.arange(B, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def stream(tokens, start: int) -> torch.Tensor:
            n = tokens.shape[1]
            positions = self._small._positions(B, n) + start
            x = self._small._embed(tokens, positions)
            if start == 0:
                mode, st = "prefill", None
            else:
                mode = "decode"
                st = torch.full((B,), start, dtype=torch.long,
                                device=self.device)

            def run(i, w, x):
                kv = {key: leaf[i] for key, leaf in cache.items()}
                return functional_call(self._block, w,
                                       (x, positions, mode, kv, rows, st))

            return self._head(self._stream_pass(x, run)[:, -1:])

        def sample(logits):
            last = logits[:, -1].float()
            if temperature <= 0:
                return last.argmax(dim=-1)
            probs = torch.softmax(last / max(temperature, 1e-6), dim=-1)
            return torch.multinomial(probs, 1, generator=gen)[:, 0]

        token = sample(stream(ids, 0))
        out = [token]
        for step in range(max_new_tokens - 1):
            token = sample(stream(token[:, None], T + step))
            out.append(token)
        toks = torch.stack(out, dim=1)
        return torch.cat([ids, toks], dim=1).cpu().numpy().astype(np.int32)
