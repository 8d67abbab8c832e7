"""Wrapper of the Myers wavefront kernel (``csrc/myers_waves.cu``).

``waves`` replaces ``mia_tpu/ops/myers_jax.py::_waves``: two IUPAC bitmaps
go in, (found_d, found_k, hist) comes out.  On an H100 the kernel is bound
by one SM's latency and issue rate, not bytes: the waves are serial in d,
and a wave costs its barrier, a lane's chain of dependent loads and, where
the band is wide, the instructions of all its lanes.  So it runs in one
block, compares 8 and then 16 bases a snake step, keeps the previous wave
in shared memory and computes only the live band of diagonals, which drops
the TPU's run-length table (~221 MB at ccheck's size); see the source for
the layout.  The kernel reads each bitmap 16-byte aligned with zero bytes
past its length (:func:`padded_bitmaps`), and writes only the lanes of the
band: the rest of the history is this wrapper's ``_NEG`` fill.

Tensors on the CPU go to the plain version,
:func:`mia_tpu_torch.ops.myers_torch.waves_plain`.  CUDA tensors go to the
kernel, or the call raises: there is no fallback.  ``kernel_launches`` /
``plain_calls`` count the two routes.
"""
from __future__ import annotations

import torch

from .dp_cuda import check_tensor
from .myers_torch import _NEG, waves_plain

# zero bytes the kernel reads past a bitmap's length (csrc/myers_waves.cu
# kSlack, checked by the loader)
SLACK = 24

kernel_launches = 0
plain_calls = 0


def reset_counts() -> None:
    global kernel_launches, plain_calls
    kernel_launches = 0
    plain_calls = 0


def padded_len(n: int) -> int:
    """Bytes the kernel takes for a bitmap of ``n`` bases: at least
    ``n + SLACK``, a multiple of 16."""
    return (n + SLACK + 15) // 16 * 16


def padded_bitmaps(bm_a: torch.Tensor, bm_b: torch.Tensor, len_a: int, len_b: int):
    """Both bitmaps in one zeroed allocation, each at a 16-byte boundary and
    ``padded_len`` bytes long: the two views the kernel reads."""
    pa = padded_len(len_a)
    buf = torch.zeros(pa + padded_len(len_b), dtype=torch.uint8, device=bm_a.device)
    buf[:len_a] = bm_a[:len_a]
    buf[pa : pa + len_b] = bm_b[:len_b]
    return buf[:pa], buf[pa:]


def waves(bm_a: torch.Tensor, bm_b: torch.Tensor, len_a: int, len_b: int, *,
          maxd: int, mode_is_prefix: bool, mode_has_prefix: bool):
    """(found_d, found_k, hist) as :func:`~mia_tpu_torch.ops.myers_torch.waves_plain`
    returns them: two ints and the [maxd + 1, 2 maxd + 1] int32 history on
    the bitmaps' device.

    bm_a [max(len_a, 1)], bm_b [max(len_b, 1)] uint8, on one device,
    contiguous; maxd >= 1."""
    global kernel_launches, plain_calls
    dev = bm_a.device
    check_tensor("bm_a", bm_a, torch.uint8, (max(len_a, 1),), dev)
    check_tensor("bm_b", bm_b, torch.uint8, (max(len_b, 1),), dev)
    if maxd < 1:
        raise ValueError(f"maxd {maxd}, want >= 1")
    if dev.type == "cpu":
        plain_calls += 1
        return waves_plain(bm_a, bm_b, len_a, len_b, maxd=maxd,
                           mode_is_prefix=mode_is_prefix, mode_has_prefix=mode_has_prefix)
    if dev.type != "cuda":
        raise ValueError(f"myers waves: no kernel for device {dev}")
    from ..utils.torchcfg import kernel_library

    lib = kernel_library()
    with torch.cuda.device(dev):
        pad_a, pad_b = padded_bitmaps(bm_a, bm_b, len_a, len_b)
        hist = torch.full((maxd + 1, 2 * maxd + 1), _NEG, dtype=torch.int32, device=dev)
        found = torch.empty(2, dtype=torch.int32, device=dev)
        rc = lib.mia_myers_waves(
            pad_a.data_ptr(), len_a, pad_b.data_ptr(), len_b, maxd, int(mode_is_prefix),
            int(mode_has_prefix), hist.data_ptr(), found.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"myers_waves kernel launch failed: CUDA error {rc}")
    kernel_launches += 1
    found_d, found_k = found.tolist()
    return found_d, found_k, hist
