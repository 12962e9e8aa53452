"""Native host runtime: bit-exact parity with the Python/JAX paths."""

import numpy as np
import pytest

from rtlsdr_wsprd_tpu import native

pytestmark = pytest.mark.skipif(
    not native.AVAILABLE, reason="native hostdsp not built")


def test_nhash_parity_exhaustive():
    from rtlsdr_wsprd_tpu.utils.nhash import hashlittle, nhash as py_nhash

    rng = np.random.default_rng(1)
    for n in range(1, 30):  # spans the 12-byte block boundary twice
        for _ in range(20):
            key = bytes(rng.integers(1, 255, n, dtype=np.uint8))
            assert native.nhash(key) == py_nhash(key)
    # full 32-bit hashlittle too
    lib = native._load()
    for key in (b"K1JT", b"0123456789ABCDEF0123"):
        assert lib.wspr_hashlittle(key, len(key), 146) == hashlittle(key, 146)


def test_conv_encode_parity():
    from rtlsdr_wsprd_tpu.utils.channel import conv_encode as py_encode

    rng = np.random.default_rng(2)
    for _ in range(10):
        data = rng.integers(0, 256, 11, dtype=np.uint8)
        data[-1] = 0
        nat = native.conv_encode(data, nsym=81)       # packed 2-bit symbols
        py = py_encode(bytes(data))[:162]              # bit pairs
        packed = 2 * py[0::2] + py[1::2]
        np.testing.assert_array_equal(nat, packed[:81])


def test_fano_oracle_matches_batched():
    """The sequential C++ Fano and the batched device Fano are the same
    machine: identical success flags, bytes, metrics AND cycle counts
    on clean, noisy and undecodable inputs."""
    import jax.numpy as jnp

    from rtlsdr_wsprd_tpu.ops.fano import batched_fano, build_mettab
    from rtlsdr_wsprd_tpu.utils.channel import conv_encode

    mettab = build_mettab()
    rng = np.random.default_rng(3)

    cases = []
    for trial in range(8):
        data = rng.integers(0, 256, 11, dtype=np.uint8)
        data[6] &= 0x80  # zero low bits like a real 50-bit payload tail
        data[7:] = 0
        bits = conv_encode(bytes(data))[:162]
        soft = np.where(bits > 0, 255, 0).astype(np.float64)
        noise_db = [0, 30, 60, 90, 110, 120, 128, 140][trial]
        soft = soft + rng.normal(0, noise_db, 162)
        cases.append(np.clip(soft, 0, 255).astype(np.uint8))
    batch = np.stack(cases)

    res = batched_fano(jnp.asarray(batch), jnp.asarray(mettab),
                       delta=60, maxcycles=200)
    n_success = 0
    for k, symbols in enumerate(cases):
        ok, data, cycles, metric, maxnp = native.fano_decode(
            symbols, mettab, delta=60, maxcycles=200)
        assert ok == bool(res.success[k]), f"case {k}"
        assert cycles == int(res.cycles[k]), f"case {k}"
        # maxnp (deepest node reached) must also match the device
        # decoder, which is itself pinned to the C oracle's maxnp
        # (tests/test_fano.py) — full fano() result parity
        assert maxnp == int(res.maxnp[k]), f"case {k}"
        if ok:
            n_success += 1
            assert metric == int(res.metric[k]), f"case {k}"
            np.testing.assert_array_equal(data, np.asarray(res.data[k]))
    assert n_success >= 2  # clean cases must decode


def test_u8_deinterleave_center():
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 256, 2048, dtype=np.uint8)
    i, q = native.u8_deinterleave_center(raw)
    np.testing.assert_array_equal(i, raw[0::2].astype(np.float32) - 128.0)
    np.testing.assert_array_equal(q, raw[1::2].astype(np.float32) - 128.0)


def test_u8_deinterleave_pairs():
    """Planar-uint8 split (the production raw path: centering happens
    on device) — native and odd-length (dangling byte dropped)."""
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 256, 2049, dtype=np.uint8)
    i, q = native.u8_deinterleave_pairs(raw)
    assert i.dtype == q.dtype == np.uint8
    np.testing.assert_array_equal(i, raw[0:2048:2])
    np.testing.assert_array_equal(q, raw[1:2048:2])


def test_quantize_into_matches_numpy():
    """Native f32 quantizer == rint/clip/nan_to_num numpy semantics."""
    import numpy as np

    from rtlsdr_wsprd_tpu import native

    rng = np.random.default_rng(5)
    x = rng.normal(0, 0.2, (7, 999)).astype(np.float32)
    x[0, :5] = [np.nan, np.inf, -np.inf, 0.5 / 254.0, -2.0]
    for dt, scale, lim in ((np.int8, 254.0, 127), (np.int16, 65534.0, 32767)):
        out = np.zeros(x.shape, dt)
        native.quantize_into(x, out, scale)
        ref = np.clip(np.nan_to_num(np.rint(x * scale)), -lim, lim)
        assert np.array_equal(out, ref.astype(dt))
