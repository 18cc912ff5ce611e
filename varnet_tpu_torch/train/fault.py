"""Transient device-fault classification: the PyTorch port of
``varnet_tpu/train/fault.py``, with the list written for CUDA.

Recovery is checkpoint-restart.  This module decides whether a runtime error
from the card is *transient* (worth an in-process retry from the newest
checkpoint) or a genuine program error (propagate).  It matches on the
exception's type and on the CUDA error's name (``cudaError_t`` by its code,
or by the runtime's fixed text for it), never on the rest of a message.

* Out of memory (``torch.cuda.OutOfMemoryError``, ``cudaErrorMemoryAllocation``
  and the cuBLAS allocation failure it causes) is deterministic for an
  unchanged program: transient only with ``include_oom=True``, for a caller
  whose retry shrinks the footprint (``refine_lm`` frees the allocator's cache
  and doubles ``k_chunks``).
* Devices busy or unavailable (another process holds the card in exclusive
  mode, the system is not ready yet) is transient.
* Sticky context errors are never transient in-process: an illegal address,
  an unspecified launch failure, an uncorrectable ECC error, a launch
  timeout, an illegal instruction.  After them the CUDA context is dead and
  every later call in the process fails again, so they propagate; the
  checkpoints serve a cross-process ``resume=True``.
* Program errors propagate: ``ValueError`` (the width and depth limits of the
  kernels), ``NotImplementedError``, an ``nvcc`` build failure, a launch with
  an invalid configuration, any error of unknown name.
"""

from __future__ import annotations

from typing import Optional

# cudaError_t of the CUDA runtime API: code -> (name, the runtime's text for it)
CUDA_ERRORS = {
    1: ("cudaErrorInvalidValue", "invalid argument"),
    2: ("cudaErrorMemoryAllocation", "out of memory"),
    9: ("cudaErrorInvalidConfiguration", "invalid configuration argument"),
    46: ("cudaErrorDevicesUnavailable", "CUDA-capable device(s) is/are busy or unavailable"),
    100: ("cudaErrorNoDevice", "no CUDA-capable device is detected"),
    214: ("cudaErrorECCUncorrectable", "uncorrectable ECC error encountered"),
    700: ("cudaErrorIllegalAddress", "an illegal memory access was encountered"),
    701: ("cudaErrorLaunchOutOfResources", "too many resources requested for launch"),
    702: ("cudaErrorLaunchTimeout", "the launch timed out and was terminated"),
    714: ("cudaErrorHardwareStackError", "hardware stack error"),
    715: ("cudaErrorIllegalInstruction", "an illegal instruction was encountered"),
    716: ("cudaErrorMisalignedAddress", "misaligned address"),
    719: ("cudaErrorLaunchFailure", "unspecified launch failure"),
    802: ("cudaErrorSystemNotReady", "system not yet initialized"),
}
# retried; every other name (the sticky context errors among them) propagates
TRANSIENT = ("cudaErrorDevicesUnavailable", "cudaErrorSystemNotReady")
OOM = ("cudaErrorMemoryAllocation", "CUBLAS_STATUS_ALLOC_FAILED")

_BY_TEXT = {text: name for name, text in CUDA_ERRORS.values()}


class CudaKernelError(RuntimeError):
    """A launch of one of the port's kernels returned a ``cudaError_t``."""

    def __init__(self, what: str, code: int):
        self.code = int(code)
        name = CUDA_ERRORS.get(self.code, (f"cudaError {self.code}",))[0]
        super().__init__(f"{what} failed with CUDA error {self.code} ({name})")


def cuda_error_name(err: BaseException) -> Optional[str]:
    """The CUDA (or cuBLAS) error name of ``err``, or None: from the code a
    kernel launch returned, from torch's ``error_code`` where it sets one, or
    from the runtime's text after torch's ``CUDA error: `` prefix."""
    code = getattr(err, "code", None)
    if code is None:
        code = getattr(err, "error_code", None)
    if isinstance(code, int) and code in CUDA_ERRORS:
        return CUDA_ERRORS[code][0]
    msg = str(err)
    if "CUBLAS_STATUS_ALLOC_FAILED" in msg:
        return "CUBLAS_STATUS_ALLOC_FAILED"
    for line in msg.splitlines():
        if line.startswith("CUDA error: "):
            return _BY_TEXT.get(line[len("CUDA error: "):].strip())
    return None


def is_transient_device_error(err: BaseException, include_oom: bool = False) -> bool:
    """True if ``err`` looks like a transient fault of the card.

    ``include_oom`` adds out-of-memory errors: pass True only when the retry
    shrinks the program's memory footprint (retrying an identical program on
    a deterministic OOM just spins).  Sticky context errors are never
    transient (see the module docstring)."""
    import torch

    if isinstance(err, torch.cuda.OutOfMemoryError):
        return include_oom
    if not isinstance(err, RuntimeError) or isinstance(err, NotImplementedError):
        return False
    name = cuda_error_name(err)
    if name in OOM:
        return include_oom
    return name in TRANSIENT
