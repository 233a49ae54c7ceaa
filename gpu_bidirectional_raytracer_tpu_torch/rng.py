"""The mix32 counter-based random tape, bit for bit as in the JAX package.

Port of the ``mix32`` implementation of ``gpu_bidirectional_raytracer_tpu/
rng.py``. Every draw is addressed by ``(key, sample, depth, purpose)``
through a chain of fold-ins, and element ``[j, i]`` of a site's
``[k, lane_total]`` block is

    x = (j * lane_total + i) ^ k0
    x ^= x >> 17;  x *= 0xed5ad4bb
    x += k1
    x ^= x >> 11;  x *= 0xac4c1b51
    x ^= x >> 15;  x *= 0x31848bab
    x ^= x >> 14
    u = (x >> 9) * 2^-23

all modulo 2^32. Keys are pairs of Python ints, derived on the host. The
per-lane bits are computed in int64 tensors masked to 32 bits, because
torch on the CPU has no uint32 add or shift; 32x32-bit products are split
in 16-bit halves so that no int64 product overflows. The same functions
run on Python ints, which is how keys are derived.

The CUDA eye-path kernel regenerates the tape in registers from the site
keys that `site_key_rows` lists, with native ``uint32_t`` arithmetic.
"""

from __future__ import annotations

import torch
from torch import Tensor

MASK32 = 0xFFFFFFFF
_MIX32_MULS = (0xed5ad4bb, 0xac4c1b51, 0x31848bab)
_MIX32_GOLD = 0x9e3779b9   # 2^32 / phi: fold_in data spreader
_MIX32_IV = (0x243f6a88, 0x85a308d3)  # pi digits: seed IV

# Purpose codes: the address space of draw sites (same values as JAX).
CAM_JITTER = 0     # sub-pixel film jitter
LIGHT_UV = 1       # light-sphere surface sampling in NEE
DIFF_UV = 2        # cosine-hemisphere scatter
REFR_RR = 3        # Fresnel Russian-roulette branch
LIGHT_RAY_UV = 4   # light-subpath emission point + direction
LIGHT_SCATTER = 5  # light-subpath bounce scatter

Key = tuple[int, int]


def _mul32(x, m: int):
    """``x * m mod 2^32`` for ``x < 2^32`` without a 64-bit overflow."""
    lo = x * (m & 0xFFFF)
    hi = (x * (m >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def _mix32(x, k1):
    """The frozen per-element hash; ``x`` and ``k1`` below 2^32 (ints or
    int64 tensors)."""
    m1, m2, m3 = _MIX32_MULS
    x = x ^ (x >> 17)
    x = _mul32(x, m1)
    x = (x + k1) & MASK32
    x = x ^ (x >> 11)
    x = _mul32(x, m2)
    x = x ^ (x >> 15)
    x = _mul32(x, m3)
    x = x ^ (x >> 14)
    return x


def make_key(seed: int) -> Key:
    """The mix32 key of an integer seed, as JAX derives it with 64-bit
    mode off (the seed becomes an int32, so its high word is 0)."""
    lo = int(seed) & MASK32
    hi = 0
    k0 = _mix32(lo ^ _MIX32_IV[0], _MIX32_IV[1])
    k1 = _mix32((hi + _MIX32_GOLD) & MASK32, k0)
    return k0, k1


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in`` for a mix32 key."""
    d = int(data) & MASK32
    k0, k1 = key
    n0 = _mix32(k0 ^ d, k1)
    n1 = _mix32((k1 + _mul32(d, _MIX32_GOLD)) & MASK32, n0)
    return n0, n1


def stream_key(key: Key, sample: int, depth: int, purpose: int) -> Key:
    """The key addressing one ``(sample, depth, purpose)`` draw site."""
    return fold_in(fold_in(fold_in(key, sample), depth), purpose)


def random_bits(key: Key, ctr: Tensor) -> Tensor:
    """mix32 bits (int64 holding uint32) at the counters ``ctr``."""
    k0, k1 = key
    return _mix32((ctr & MASK32) ^ k0, k1)


def bits_to_uniform(bits: Tensor) -> Tensor:
    """Top 23 bits to a float32 uniform in [0, 1)."""
    return (bits >> 9).to(torch.float32) * (2.0 ** -23)


def site_uniforms(key: Key, sample: int, depth: int, purpose: int,
                  k: int, n: int, *, device: str | torch.device,
                  lane_offset: int | None = None,
                  lane_total: int | None = None,
                  lane_ids: Tensor | None = None) -> Tensor:
    """``[k, n]`` float32 uniforms for one draw site, one column per lane.

    ``lane_offset``/``lane_total``: columns ``[lane_offset, lane_offset+n)``
    of the ``[k, lane_total]`` site block. ``lane_ids``: column
    ``lane_ids[i]`` of that block at position ``i``. Values depend only on
    the global counter, never on the lane position.
    """
    ks = stream_key(key, sample, depth, purpose)
    rows = torch.arange(k, dtype=torch.int64, device=device)[:, None]
    if lane_ids is not None:
        if lane_total is None:
            raise ValueError("lane_ids requires lane_total")
        cols = lane_ids.to(device=device, dtype=torch.int64)[None, :]
        total = lane_total
    elif lane_offset is not None:
        if lane_total is None:
            raise ValueError("lane_offset requires lane_total")
        cols = (torch.arange(n, dtype=torch.int64, device=device)
                + int(lane_offset))[None, :]
        total = lane_total
    else:
        cols = torch.arange(n, dtype=torch.int64, device=device)[None, :]
        total = n
    return bits_to_uniform(random_bits(ks, rows * total + cols))


def site_key_rows(key: Key, sample: int, depth: int, purpose: int,
                  rows: list[int]) -> list[tuple[int, int, int]]:
    """``(k0, k1, row)`` for the given block rows of one draw site: what
    the CUDA kernel needs to regenerate those tape rows in registers."""
    k0, k1 = stream_key(key, sample, depth, purpose)
    return [(k0, k1, r) for r in rows]
