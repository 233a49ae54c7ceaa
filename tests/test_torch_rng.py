"""The port's tapes equal the JAX package's bit for bit: the frozen mix32
contract vectors of tests/test_core.py::TestMix32Contract, and whole
`site_uniforms` tapes over sites, depths and lane windows, for mix32 and
for the partitionable threefry of ``jax.random`` (``impl="threefry"``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_bidirectional_raytracer_tpu import rng as jrng
from gpu_bidirectional_raytracer_tpu_torch import rng as trng

torch.set_num_threads(2)

SEED_VECTORS = {
    0: (1197142749, 149646298),
    1: (2076871732, 3744768917),
    42: (1467968187, 1538299671),
    123456789: (4146660287, 1851957059),
}
FOLD_42_7 = (2816824906, 1087184347)
STREAM_42_3_2_DIFF = (1088192210, 372474305)
BITS_8 = (548861987, 1529853855, 2658193586, 2202051641,
          4195756677, 650042591, 1373203663, 3478316495)
UNIFORM_8 = (0.127791882, 0.356196761, 0.618908882, 0.512705088,
             0.976900697, 0.151349783, 0.319723845, 0.809858561)


def _jax_words(key):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


class TestFrozenVectors:
    @pytest.mark.parametrize("seed", sorted(SEED_VECTORS))
    def test_seed_vectors(self, seed):
        assert trng.make_key(seed) == SEED_VECTORS[seed]
        assert trng.make_key(seed) == _jax_words(jrng.make_key(seed))

    def test_fold_in_and_stream_key(self):
        k = trng.make_key(42)
        assert trng.fold_in(k, 7) == FOLD_42_7
        assert trng.stream_key(k, 3, 2, trng.DIFF_UV) == STREAM_42_3_2_DIFF

    def test_bits_and_uniforms(self):
        ks = trng.stream_key(trng.make_key(42), 3, 2, trng.DIFF_UV)
        bits = trng.random_bits(ks, torch.arange(8))
        assert tuple(bits.tolist()) == BITS_8
        model = jrng.mix32_reference(*ks, np.arange(8))
        assert np.array_equal(bits.numpy().astype(np.uint32), model)
        u = trng.bits_to_uniform(bits).numpy()
        np.testing.assert_allclose(u, UNIFORM_8, rtol=0, atol=2e-9)
        expect = (np.asarray(BITS_8, np.uint32) >> np.uint32(9)
                  ).astype(np.float32) * np.float32(2.0 ** -23)
        assert np.array_equal(u, expect)

    def test_purpose_codes_match(self):
        for name in ("CAM_JITTER", "LIGHT_UV", "DIFF_UV", "REFR_RR",
                     "LIGHT_RAY_UV", "LIGHT_SCATTER"):
            assert getattr(trng, name) == getattr(jrng, name)


class TestTapesBitwise:
    @pytest.mark.parametrize("seed,sample,depth,purpose,k,n", [
        (0, 0, 0, jrng.CAM_JITTER, 2, 257),
        (5, 3, 1, jrng.LIGHT_UV, 4, 64),
        (7, 11, 6, jrng.DIFF_UV, 2, 1000),
        (123456789, 29999, 2, jrng.REFR_RR, 1, 333),
        (-3, 1, 0, jrng.LIGHT_RAY_UV, 4, 128),
    ])
    def test_site_uniforms(self, seed, sample, depth, purpose, k, n):
        ref = np.asarray(jrng.site_uniforms(jrng.make_key(seed), sample,
                                            depth, purpose, k, n))
        got = trng.site_uniforms(trng.make_key(seed), sample, depth,
                                 purpose, k, n, device="cpu").numpy()
        assert got.dtype == np.float32
        assert np.array_equal(got, ref)

    @pytest.mark.parametrize("offset,n,total", [(0, 16, 64), (8, 16, 64),
                                                (100, 77, 4096)])
    def test_lane_windows(self, offset, n, total):
        jk, tk = jrng.make_key(9), trng.make_key(9)
        ref = np.asarray(jrng.site_uniforms(
            jk, 2, 3, jrng.LIGHT_SCATTER, 3, n, lane_offset=offset,
            lane_total=total))
        got = trng.site_uniforms(tk, 2, 3, trng.LIGHT_SCATTER, 3, n,
                                 device="cpu", lane_offset=offset,
                                 lane_total=total).numpy()
        assert np.array_equal(got, ref)

    def test_lane_ids(self):
        ids = np.array([5, 3, 60, 0, 63], np.int32)
        ref = np.asarray(jrng.site_uniforms(
            jrng.make_key(5), 3, 1, jrng.LIGHT_UV, 2, 5,
            lane_ids=jnp.asarray(ids), lane_total=64))
        got = trng.site_uniforms(trng.make_key(5), 3, 1, trng.LIGHT_UV, 2, 5,
                                 device="cpu", lane_ids=torch.as_tensor(ids),
                                 lane_total=64).numpy()
        assert np.array_equal(got, ref)

    def test_site_key_rows_regenerate_tape(self):
        """The (k0, k1, row) triples the CUDA kernel receives rebuild the
        tape with the kernel's formula, mix32((row*total + lane) ^ k0, k1)."""
        key = trng.make_key(3)
        total = 96
        ref = trng.site_uniforms(key, 4, 2, trng.LIGHT_UV, 4, total,
                                 device="cpu")
        lanes = torch.arange(total, dtype=torch.int64)
        for k0, k1, row in trng.site_key_rows(key, 4, 2, trng.LIGHT_UV,
                                              [2, 0, 3, 1]):
            bits = trng._mix32(((row * total + lanes) & trng.MASK32) ^ k0,
                               k1)
            assert torch.equal(trng.bits_to_uniform(bits), ref[row])


class TestThreefry:
    @pytest.mark.parametrize("seed", [0, 1, 42, -3, 123456789])
    def test_keys_fold_in_and_stream_key(self, seed):
        jk = jrng.make_key(seed, "threefry")
        tk = trng.make_key(seed, "threefry")
        assert trng.key_impl(tk) == "threefry"
        assert tk == _jax_words(jk) == _jax_words(jax.random.key(seed))
        for data in (0, 7, 0x5EED, 2**32 - 1):
            got = trng.fold_in(tk, data)
            assert trng.key_impl(got) == "threefry"
            assert got == _jax_words(jax.random.fold_in(jk, data))
        assert trng.stream_key(tk, 3, 2, trng.DIFF_UV) == _jax_words(
            jrng.stream_key(jk, 3, 2, jrng.DIFF_UV))

    @pytest.mark.parametrize("seed,sample,depth,purpose,k,n", [
        (0, 0, 0, jrng.CAM_JITTER, 2, 257),
        (5, 3, 1, jrng.LIGHT_UV, 4, 64),
        (123456789, 29999, 6, jrng.REFR_RR, 1, 333),
    ])
    def test_site_uniforms(self, seed, sample, depth, purpose, k, n):
        ref = np.asarray(jrng.site_uniforms(jrng.make_key(seed, "threefry"),
                                            sample, depth, purpose, k, n))
        got = trng.site_uniforms(trng.make_key(seed, "threefry"), sample,
                                 depth, purpose, k, n, device="cpu").numpy()
        assert got.dtype == np.float32
        assert np.array_equal(got, ref)

    @pytest.mark.parametrize("offset,n,total", [(0, 16, 64), (8, 16, 64),
                                                (100, 77, 4096)])
    def test_lane_windows(self, offset, n, total):
        jk, tk = jrng.make_key(9, "threefry"), trng.make_key(9, "threefry")
        ref = np.asarray(jrng.site_uniforms(
            jk, 2, 3, jrng.LIGHT_SCATTER, 3, n, lane_offset=offset,
            lane_total=total))
        got = trng.site_uniforms(tk, 2, 3, trng.LIGHT_SCATTER, 3, n,
                                 device="cpu", lane_offset=offset,
                                 lane_total=total).numpy()
        assert np.array_equal(got, ref)

    def test_lane_ids_and_bits(self):
        ids = np.array([5, 3, 60, 0, 63], np.int32)
        jk, tk = jrng.make_key(5, "threefry"), trng.make_key(5, "threefry")
        ref = np.asarray(jrng.site_uniforms(
            jk, 3, 1, jrng.LIGHT_UV, 2, 5, lane_ids=jnp.asarray(ids),
            lane_total=64))
        got = trng.site_uniforms(tk, 3, 1, trng.LIGHT_UV, 2, 5,
                                 device="cpu", lane_ids=torch.as_tensor(ids),
                                 lane_total=64).numpy()
        assert np.array_equal(got, ref)
        bits = trng.random_bits(tk, torch.arange(300, dtype=torch.int64))
        want = np.asarray(jax.random.bits(jk, (300,), jnp.uint32))
        assert np.array_equal(bits.numpy().astype(np.uint32), want)

    def test_rbg_is_not_ported(self):
        """The rbg tape is ported now (`TestRbg`): ``make_key(0, "rbg")``
        gives an `RbgKey`; an unknown tape still raises, and the default
        is mix32."""
        assert trng.key_impl(trng.make_key(0, "rbg")) == "rbg"
        with pytest.raises(ValueError):
            trng.make_key(0, "philox")
        assert trng.key_impl(trng.make_key(0)) == "mix32"

    @pytest.mark.parametrize("impl", ["mix32", "threefry", "rbg"])
    def test_rows_uniforms_are_site_uniforms(self, impl):
        """The rows the streamed tape is made of, all sites in one pass,
        equal `site_uniforms` row by row, in a window and whole."""
        key = trng.make_key(21, impl)
        sites = [(4, 0, trng.LIGHT_UV, [2, 0, 3]), (4, 1, trng.DIFF_UV, [1]),
                 (5, 2, trng.REFR_RR, [0])]
        rows = [r for s, d, p, b in sites
                for r in trng.site_key_rows(key, s, d, p, b)]
        for lo, total in ((None, None), (30, 200)):
            got = trng.rows_uniforms(impl, rows, 50, device="cpu",
                                     lane_offset=lo, lane_total=total)
            want = torch.cat([trng.site_uniforms(
                key, s, d, p, max(b) + 1, 50, device="cpu", lane_offset=lo,
                lane_total=total)[b] for s, d, p, b in sites])
            assert torch.equal(got, want)


@pytest.mark.parametrize("impl", ["mix32", "threefry"])
class TestWholeShapeDraws:
    """`uniforms`, `fill_pool` and `normals` against JAX's `rng`: the
    uniforms bit for bit; the normals within ``1e-5 |ref| + 1e-7`` (the
    uniforms are JAX's bits, but ``torch.special.erfinv`` is not XLA's
    erf_inv; measured up to 5.7e-6 relative over 2e5 draws)."""

    @pytest.mark.parametrize("seed,shape", [(0, (7, 33)), (42, (1000,)),
                                            (-3, (2, 3, 5))])
    def test_uniforms(self, impl, seed, shape):
        ref = np.asarray(jrng.uniforms(jrng.make_key(seed, impl), 3, 2,
                                       jrng.DIFF_UV, shape))
        got = trng.uniforms(trng.make_key(seed, impl), 3, 2, trng.DIFF_UV,
                            shape, device="cpu").numpy()
        assert got.dtype == np.float32 and np.array_equal(got, ref)

    def test_fill_pool(self, impl):
        for sample in (0, 9):
            ref = np.asarray(jrng.fill_pool(jrng.make_key(5, impl), 4099,
                                            sample))
            got = trng.fill_pool(trng.make_key(5, impl), 4099, sample,
                                 device="cpu").numpy()
            assert np.array_equal(got, ref)

    def test_normals(self, impl):
        ref = np.asarray(jrng.normals(jrng.make_key(7, impl), 1, 0, 3,
                                      (50000,)))
        got = trng.normals(trng.make_key(7, impl), 1, 0, 3, (50000,),
                           device="cpu").numpy()
        assert got.dtype == np.float32
        assert (np.abs(got - ref) <= 1e-5 * np.abs(ref) + 1e-7).all()
        assert abs(got.mean()) < 0.02 and abs(got.std() - 1.0) < 0.02


@pytest.mark.parametrize("seed", [0, 42])
def test_mix32_reference_matches_jax(seed):
    """The port's numpy model of the mix32 bits against JAX's, on random
    counters (numpy seed) of random site keys, and against the port's
    tensor hash."""
    r = np.random.default_rng(seed)
    for _ in range(4):
        k0, k1 = (int(w) for w in r.integers(0, 2 ** 32, 2))
        ctr = r.integers(0, 2 ** 32, 4096, dtype=np.uint64)
        got = trng.mix32_reference(k0, k1, ctr)
        assert got.dtype == np.uint32
        assert np.array_equal(got, jrng.mix32_reference(k0, k1, ctr))
        bits = trng.random_bits((k0, k1), torch.tensor(ctr.astype(np.int64)))
        assert np.array_equal(bits.numpy().astype(np.uint32), got)


def test_mwc_bit_for_bit():
    for s0, s1 in ((1, 2), (0xDEADBEEF, 12345), (2**32 - 1, 0)):
        assert trng.mwc_random(s0, s1) == jrng.mwc_random(s0, s1)
        got, ref = trng.mwc_sequence(s0, s1, 257), jrng.mwc_sequence(
            s0, s1, 257)
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


class TestRbg:
    """The rbg tape: JAX's key words and fold-ins, bits from a
    ``torch.Generator`` seeded per site and row (not JAX's bits, so
    checked statistically), and lane windows that are slices of the whole
    block."""

    @pytest.mark.parametrize("seed", [0, 5, -3])
    def test_key_words_and_fold_in_are_jax(self, seed):
        jk, tk = jrng.make_key(seed, "rbg"), trng.make_key(seed, "rbg")
        assert isinstance(tk, trng.RbgKey) and tk == _jax_words(jk)
        for data in (0, 3, 2**32 - 1):
            got = trng.fold_in(tk, data)
            assert trng.key_impl(got) == "rbg"
            assert got == _jax_words(jax.random.fold_in(jk, data))

    def test_windows_and_lane_ids_are_slices_of_the_block(self):
        key = trng.make_key(11, "rbg")
        full = trng.site_uniforms(key, 2, 1, trng.LIGHT_UV, 4, 4096,
                                  device="cpu")
        win = trng.site_uniforms(key, 2, 1, trng.LIGHT_UV, 4, 77,
                                 device="cpu", lane_offset=100,
                                 lane_total=4096)
        assert torch.equal(win, full[:, 100:177])
        # More rows leave the first rows as they were.
        assert torch.equal(trng.site_uniforms(
            key, 2, 1, trng.LIGHT_UV, 2, 4096, device="cpu"), full[:2])
        ids = torch.tensor([5, 3, 4000, 0, 63])
        got = trng.site_uniforms(key, 2, 1, trng.LIGHT_UV, 4, 5,
                                 device="cpu", lane_ids=ids,
                                 lane_total=4096)
        assert torch.equal(got, full[:, ids])
        assert torch.equal(trng.uniforms(key, 2, 1, trng.LIGHT_UV, (4096,),
                                         device="cpu"), full[0])
        other = trng.site_uniforms(key, 3, 1, trng.LIGHT_UV, 4, 4096,
                                   device="cpu")
        assert not torch.equal(other, full)
        with pytest.raises(ValueError, match="counter bits"):
            trng.random_bits(key, torch.arange(4))

    def test_statistics(self):
        """Mean, variance and a 16-bin chi-square of 2^16 draws of each
        of two sites, within about five standard errors (chi-square with
        15 degrees of freedom: mean 15, sd 5.5)."""
        key = trng.make_key(0, "rbg")
        for sample in (0, 1):
            u = trng.site_uniforms(key, sample, 0, trng.CAM_JITTER, 2,
                                   1 << 15, device="cpu").reshape(-1)
            assert u.dtype == torch.float32
            assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
            assert abs(float(u.mean()) - 0.5) < 0.006
            assert abs(float(u.var()) - 1.0 / 12.0) < 0.0015
            counts = torch.bincount((u * 16).long(), minlength=16).double()
            expect = u.numel() / 16
            assert float(((counts - expect) ** 2 / expect).sum()) < 45.0
        n = trng.normals(key, 0, 0, 7, (1 << 16,), device="cpu")
        assert abs(float(n.mean())) < 0.02
        assert abs(float(n.std()) - 1.0) < 0.02
