from .abstract_accelerator import Accelerator  # noqa: F401
from .real_accelerator import (  # noqa: F401
    CpuAccelerator,
    CudaAccelerator,
    copy_from_host,
    get_accelerator,
    resolve_device,
)
