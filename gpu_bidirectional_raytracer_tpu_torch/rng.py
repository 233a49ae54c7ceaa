"""The counter-based random tapes, bit for bit as in the JAX package.

Port of ``gpu_bidirectional_raytracer_tpu/rng.py``: every draw is
addressed by ``(key, sample, depth, purpose)`` through a chain of
fold-ins, and element ``[j, i]`` of a site's ``[k, lane_total]`` block is
a pure function of the site key and the counter ``j * lane_total + i``.
Two implementations sit behind it, and the key carries which, as JAX's
typed keys do:

- ``mix32`` (the default; a plain pair of ints): the frozen hash

      x = ctr ^ k0
      x ^= x >> 17;  x *= 0xed5ad4bb
      x += k1
      x ^= x >> 11;  x *= 0xac4c1b51
      x ^= x >> 15;  x *= 0x31848bab
      x ^= x >> 14

- ``threefry`` (a :class:`ThreefryKey`): JAX's partitionable
  threefry2x32, the tape of ``jax.random.key(seed)``. The bits of counter
  ``c`` are ``y0 ^ y1`` with ``(y0, y1) = threefry2x32(key, (c >> 32, c &
  0xffffffff))``, and ``fold_in(key, d)`` is ``threefry2x32(key, (0,
  d))``.

Both map bits to ``u = (x >> 9) * 2^-23``, all arithmetic modulo 2^32.
Keys are pairs of Python ints, derived on the host. The per-lane bits are
computed in int64 tensors masked to 32 bits, because torch on the CPU has
no uint32 add or shift; 32x32-bit products are split in 16-bit halves so
that no int64 product overflows. The same functions run on Python ints,
which is how keys are derived.

A third kind of key, ``rbg`` (an :class:`RbgKey`, the tape of
``--rng rbg`` / ``--fast-rng``), has JAX's four key words and fold-ins,
but its bits come from ``torch.Generator`` (`_rbg_rows`); it is not
JAX's tape and is checked statistically.

The CUDA kernels regenerate a mix32 tape in registers from the site keys
that `site_key_rows` lists; a threefry or rbg tape is built here, on the
device, and streamed to them as a ``[K, n]`` buffer.

`uniforms`, `normals` and `fill_pool` draw whole shapes from one site;
`mwc_random` and `mwc_sequence` are the reference's CPU generator, kept
for parity tests (the renderer never uses them). `mix32_reference` is an
independent numpy model of the mix32 bits, the oracle of the tests.

JAX's ``mix32_is_registered`` has no counterpart: it reports whether mix32
is registered as a JAX PRNG implementation, and here the key's type says
which tape it draws (`key_impl`), with nothing to register.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor

from gpu_bidirectional_raytracer_tpu_torch.core.types import resolve_device

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

_TF_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TF_PARITY = 0x1BD11BDA

IMPLS = ("mix32", "threefry", "rbg")


class ThreefryKey(tuple):
    """A threefry2x32 key: its two words, typed so that every function of
    this module draws the threefry tape from it."""

    __slots__ = ()
    impl = "threefry"


class RbgKey(tuple):
    """An rbg key: JAX's four words (two threefry halves, each folded like
    a threefry key). Its tape comes from ``torch.Generator`` on the tape's
    device, seeded from the site key and the block row (`_rbg_rows`), so
    element ``[j, i]`` of a site's ``[k, lane_total]`` block depends only
    on the key, the site, the row and ``lane_total``, and a lane window is
    a slice of the whole block. It is not replay-stable across devices
    (the CPU's and the card's generators differ) nor equal to JAX's rbg
    bits, so it is checked statistically. The CUDA kernels read it as a
    streamed ``[K, n]`` tape, like a threefry one: on the card it is not
    faster than mix32, which the kernels regenerate in registers. It
    exists for the CLI's ``--rng rbg`` and ``--fast-rng``."""

    __slots__ = ()
    impl = "rbg"


Key = tuple[int, ...]   # a mix32 key (two words); ThreefryKey and RbgKey


def key_impl(key: Key) -> str:
    """``"mix32"``, ``"threefry"`` or ``"rbg"``: the tape ``key`` draws."""
    return getattr(key, "impl", "mix32")


def make_typed_key(words, impl: str) -> Key:
    """The key of ``impl`` with the given words (``list(key)`` of such a
    key): how a stored key is rebuilt."""
    words = tuple(int(w) & MASK32 for w in words)
    if impl not in IMPLS:
        raise ValueError(f"unknown tape {impl!r}")
    if len(words) != (4 if impl == "rbg" else 2):
        raise ValueError(f"a {impl} key has {4 if impl == 'rbg' else 2} "
                         f"words, got {len(words)}")
    return {"mix32": tuple, "threefry": ThreefryKey,
            "rbg": RbgKey}[impl](words)


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


def mix32_reference(k0: int, k1: int, ctr) -> np.ndarray:
    """Independent numpy model of the frozen mix32 bits (uint32) at the
    counters ``ctr``: the oracle of the tests, sharing no code with
    `_mix32`."""
    with np.errstate(over="ignore"):
        x = np.asarray(ctr, np.uint64) & 0xFFFFFFFF
        x = (x ^ np.uint64(k0)) & 0xFFFFFFFF
        x ^= x >> np.uint64(17)
        x = (x * np.uint64(0xed5ad4bb)) & 0xFFFFFFFF
        x = (x + np.uint64(k1)) & 0xFFFFFFFF
        x ^= x >> np.uint64(11)
        x = (x * np.uint64(0xac4c1b51)) & 0xFFFFFFFF
        x ^= x >> np.uint64(15)
        x = (x * np.uint64(0x31848bab)) & 0xFFFFFFFF
        x ^= x >> np.uint64(14)
        return x.astype(np.uint32)


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def _threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32, 20 rounds (JAX's ``threefry2x32``), on words below
    2^32 (ints or int64 tensors)."""
    ks = (k0, k1, k0 ^ k1 ^ _TF_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _TF_ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def make_key(seed: int, impl: str | None = None) -> Key:
    """The key of an integer seed for ``impl`` (None or ``"mix32"``,
    ``"threefry"`` or ``"rbg"``), as JAX derives it with 64-bit mode off:
    the seed becomes an int32, so its high word is 0."""
    lo = int(seed) & MASK32
    if impl == "threefry":
        return ThreefryKey((0, lo))
    if impl == "rbg":
        return RbgKey((0, lo, 0, lo))
    if impl not in (None, "mix32"):
        raise ValueError(f"unknown tape {impl!r}")
    hi = 0
    k0 = _mix32(lo ^ _MIX32_IV[0], _MIX32_IV[1])
    k1 = _mix32((hi + _MIX32_GOLD) & MASK32, k0)
    return k0, k1


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in`` for every kind of key."""
    d = int(data) & MASK32
    if key_impl(key) == "rbg":
        return RbgKey(_threefry2x32(*key[:2], 0, d)
                      + _threefry2x32(*key[2:], 0, d))
    k0, k1 = key
    if key_impl(key) == "threefry":
        return ThreefryKey(_threefry2x32(k0, k1, 0, d))
    n0 = _mix32(k0 ^ d, k1)
    n1 = _mix32((k1 + _mul32(d, _MIX32_GOLD)) & MASK32, n0)
    return n0, n1


def stream_key(key: Key, sample: int, depth: int, purpose: int) -> Key:
    """The key addressing one ``(sample, depth, purpose)`` draw site."""
    return fold_in(fold_in(fold_in(key, sample), depth), purpose)


def random_bits(key: Key, ctr: Tensor) -> Tensor:
    """The bits (int64 holding uint32) at the counters ``ctr`` (int64, at
    or above 0) of a mix32 or threefry key."""
    if key_impl(key) == "rbg":
        raise ValueError("an rbg tape has no counter bits; draw it with "
                         "site_uniforms or uniforms")
    k0, k1 = key
    if key_impl(key) == "threefry":
        y0, y1 = _threefry2x32(k0, k1, ctr >> 32, ctr & MASK32)
        return y0 ^ y1
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
    if key_impl(key) == "rbg":
        return _rbg_site(ks, k, n, device, lane_offset, lane_total,
                         lane_ids)
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
                  rows: list[int]) -> list[tuple[int, ...]]:
    """``(*site key words, row)`` for the given block rows of one draw
    site (``(k0, k1, row)`` for mix32 and threefry). The CUDA kernels
    regenerate mix32 rows from them in registers; `rows_uniforms` makes
    the rows of any key."""
    ks = stream_key(key, sample, depth, purpose)
    return [(*ks, r) for r in rows]


def rows_uniforms(impl: str, key_rows: list[tuple[int, int, int]], n: int,
                  *, device: str | torch.device,
                  lane_offset: int | None = None,
                  lane_total: int | None = None) -> Tensor:
    """``[R, n]`` float32: row ``i`` is block row ``key_rows[i][2]`` of
    the site whose key words are ``key_rows[i][:2]`` (`site_key_rows`),
    for lanes ``[lane_offset, lane_offset + n)`` of a ``lane_total``-lane
    block (default: the ``n`` lanes). The same values as `site_uniforms`
    row by row, made in one pass over all the rows (an rbg tape: one
    generator a row)."""
    if impl == "rbg":
        return torch.cat([_rbg_rows(RbgKey(kr[:4]), [kr[4]], n, device,
                                    lane_offset, lane_total)
                          for kr in key_rows])
    words = torch.tensor(key_rows, dtype=torch.int64,
                         device=device).reshape(-1, 3)
    k0, k1, row = words[:, 0:1], words[:, 1:2], words[:, 2:3]
    total = n if lane_total is None else lane_total
    cols = torch.arange(n, dtype=torch.int64, device=device) + int(
        lane_offset or 0)
    ctr = row * total + cols[None, :]
    if impl == "threefry":
        y0, y1 = _threefry2x32(k0, k1, ctr >> 32, ctr & MASK32)
        return bits_to_uniform(y0 ^ y1)
    return bits_to_uniform(_mix32((ctr & MASK32) ^ k0, k1))


def _rbg_seed(site_key: Key, row: int) -> int:
    """The 64-bit generator seed of one block row of an rbg site."""
    w = fold_in(site_key, row)
    return (w[0] << 32) | w[1]


def _rbg_rows(site_key: Key, rows: list[int], n: int, device,
              lane_offset: int | None = None,
              lane_total: int | None = None) -> Tensor:
    """``[len(rows), n]`` float32: lanes ``[lane_offset, lane_offset + n)``
    of the given rows of an rbg site's ``lane_total``-lane block. Each row
    is one ``torch.rand`` of ``lane_total`` from a generator on ``device``
    seeded by `_rbg_seed`, so a window is a slice of the whole row."""
    total = n if lane_total is None else lane_total
    off = int(lane_offset or 0)
    dev = torch.device(device)
    out = []
    for r in rows:
        gen = torch.Generator(device=dev)
        gen.manual_seed(_rbg_seed(site_key, r))
        full = torch.rand(total, generator=gen, dtype=torch.float32,
                          device=dev)
        out.append(full[off:off + n])
    return torch.stack(out)


def _rbg_site(site_key: Key, k: int, n: int, device, lane_offset,
              lane_total, lane_ids) -> Tensor:
    """`site_uniforms` of an rbg site key."""
    if lane_ids is not None:
        if lane_total is None:
            raise ValueError("lane_ids requires lane_total")
        full = _rbg_rows(site_key, list(range(k)), lane_total, device)
        return full[:, lane_ids.to(device=full.device, dtype=torch.int64)]
    if lane_offset is not None and lane_total is None:
        raise ValueError("lane_offset requires lane_total")
    return _rbg_rows(site_key, list(range(k)), n, device, lane_offset,
                     lane_total)


def uniforms(key: Key, sample: int, depth: int, purpose: int, shape, *,
             device: str | torch.device = "cuda") -> Tensor:
    """Float32 uniforms in [0, 1) of shape ``shape`` from one draw site:
    element ``i`` of the flattened shape is counter ``i`` of the site
    (``jax.random.uniform`` of `stream_key`; for mix32 and threefry keys
    bit for bit JAX's `rng.uniforms`). Equal to row 0 of
    ``site_uniforms(..., 1, prod(shape))`` for every kind of key."""
    shape = tuple(int(s) for s in shape)
    numel = math.prod(shape)
    return site_uniforms(key, sample, depth, purpose, 1, numel,
                         device=resolve_device(device))[0].reshape(shape)


# The lower end of `normals`' uniforms: the float32 after -1 towards 0
# (``jax.random.normal``'s ``lo``); the span ``1 - lo`` rounds to 2.
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normals(key: Key, sample: int, depth: int, purpose: int, shape, *,
            device: str | torch.device = "cuda") -> Tensor:
    """Float32 standard normals from one draw site, as
    ``jax.random.normal`` makes them: ``sqrt(2) * erfinv(u)`` with ``u =
    max(lo, 2 * `uniforms` + lo)`` uniform on ``(-1, 1)``. The uniforms
    are JAX's bits; ``torch.special.erfinv`` is not XLA's, so the values
    agree with JAX's to a tolerance (tests/test_torch_rng.py), not bit for
    bit."""
    u = uniforms(key, sample, depth, purpose, shape, device=device)
    u = torch.clamp(u * 2.0 + _NORMAL_LO, min=_NORMAL_LO)
    return torch.special.erfinv(u) * float(np.float32(math.sqrt(2.0)))


def fill_pool(key: Key, n: int, sample: int = 0, *,
              device: str | torch.device = "cuda") -> Tensor:
    """A flat pool of ``n`` uniforms (the reference's pool fill), from the
    site ``(sample, 0, 0xFFFF)``; for tools and tests."""
    return uniforms(key, sample, 0, 0xFFFF, (n,), device=device)


# -- The reference's CPU generator (parity tests only) ------------------------

def mwc_random(seed0: int, seed1: int) -> tuple[float, int, int]:
    """One step of the reference's two-seed multiply-with-carry generator.

    Returns ``(float in [0, 1), new_seed0, new_seed1)``, bit for bit,
    including the mantissa trick: the low 23 bits under the exponent of 2
    give a float in [2, 4), mapped by ``(f - 2) / 2``."""
    seed0 = (36969 * (seed0 & 0xFFFF) + (seed0 >> 16)) & MASK32
    seed1 = (18000 * (seed1 & 0xFFFF) + (seed1 >> 16)) & MASK32
    ires = ((seed0 << 16) + seed1) & MASK32
    bits = np.uint32((ires & 0x007FFFFF) | 0x40000000)
    f = float(np.frombuffer(bits.tobytes(), dtype=np.float32)[0])
    return (f - 2.0) / 2.0, seed0, seed1


def mwc_sequence(seed0: int, seed1: int, n: int) -> np.ndarray:
    """``n`` successive `mwc_random` draws as float32 (host side)."""
    out = np.empty((n,), dtype=np.float32)
    for i in range(n):
        out[i], seed0, seed1 = mwc_random(seed0, seed1)
    return out
