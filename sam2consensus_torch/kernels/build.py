"""Build and bind the hand-written CUDA kernels in ``csrc/``.

One ``torch.utils.cpp_extension.load`` call builds every source at first
use into ``build/torch_kernels/`` at the root of the checkout (ninja
rebuilds what changed): the kernels (``pileup.cu``, ``insertion.cu``,
plain CUDA, no PyTorch headers) and ``binding.cpp``, the one file that
includes ``torch/extension.h`` and exposes a typed tensor entry point per
kernel.  ``kernels.h`` states the entry points' parameters once for both
sides.  A failed build raises: nothing here degrades to the plain PyTorch
versions.  A build or load failure is marked ``kernel_build``
(:meth:`Kernel.function`), and any error a kernel's call raises (a refused
launch, an entry point's contract check) ``kernel_launch``
(:meth:`Kernel.launch`); the retry policy classifies both PASSTHROUGH, so
no ``--on-device-error`` mode retries or demotes past a kernel that did
not build, load or launch.

:class:`Kernel` is one entry point and its launch count.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import List, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("binding.cpp", "pileup.cu", "insertion.cu")
NAME = "s2c_torch_kernels"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

_EXTENSION = None
_LOAD_LOCK = threading.Lock()


def extension():
    """The built extension module (built, or loaded, on the first call;
    counted ``compile/persist_hit`` or ``compile/persist_miss`` by
    ``observability.jitcache``).  One thread builds: a serve prewarm
    thread and a job's first launch that ask at once share its load."""
    global _EXTENSION
    if _EXTENSION is None:
        with _LOAD_LOCK:
            if _EXTENSION is None:
                from torch.utils.cpp_extension import load

                from ..observability.jitcache import counted_load

                BUILD_DIR.mkdir(parents=True, exist_ok=True)  # load does not
                _EXTENSION = counted_load(
                    lambda: load(
                        NAME, [str(CSRC / s) for s in SOURCES],
                        extra_cflags=["-O3"], extra_cuda_cflags=CUDA_FLAGS,
                        build_directory=str(BUILD_DIR)),
                    str(BUILD_DIR / f"{NAME}.so"))
    return _EXTENSION


class Kernel:
    """One typed entry point of the extension (``csrc/binding.cpp``).

    :meth:`launch` calls it with the wrapper's tensors and ints (the entry
    point checks them, raises on a refused launch and returns the number of
    kernel launches it made) and is the only place ``launches`` grows.  It
    also adds them to the launching thread's run registry
    (``kernel/launches/<name>``), so a served job's or a session wave's own
    launches land in its per-job record.
    """

    def __init__(self, name: str, source: str):
        self.name = name          # the entry point in binding.cpp
        self.source = source      # the kernel's file in csrc/
        self.launches = 0

    def function(self):
        try:
            return getattr(extension(), self.name)
        except BaseException as exc:
            # the build's own error, marked: never retried, never demoted
            # past (resilience.policy.classify)
            _mark(exc, "kernel_build")
            raise

    def launch(self, *args) -> None:
        fn = self.function()
        try:
            n = fn(*args)
        except BaseException as exc:
            # a refused launch or a failed contract check in the entry
            # point: a fault of the kernel or its wrapper, which no rung
            # may carry the run past (resilience.policy.classify)
            _mark(exc, "kernel_launch")
            raise
        self.launches += n
        from ..observability.metrics import current

        current().add(f"kernel/launches/{self.name}", n)


def _mark(exc: BaseException, marker: str) -> None:
    try:
        setattr(exc, marker, True)
    except AttributeError:  # pragma: no cover - exotic exception
        pass


def all_kernels() -> List[Kernel]:
    """Every kernel of the package, in path order (K1, K2, K3)."""
    from ..ops import insertion_kernel, pileup_kernel

    return [pileup_kernel.K1, insertion_kernel.K2, insertion_kernel.K3]


def reset_launches(kernels: Optional[Sequence[Kernel]] = None) -> None:
    for k in kernels if kernels is not None else all_kernels():
        k.launches = 0
