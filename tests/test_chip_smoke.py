"""chip_smoke.py off the card: it refuses to run without a GPU, and its
float64 references agree with the JAX ops they check (on the CPU, where
float32 matmuls run at full float32 precision)."""

import importlib.util
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_refuses_cpu():
    """No GPU: a non-zero exit with its message, and no result line."""
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "JAX found no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_ref_polyphase_matches_stage1(smoke):
    from rtlsdr_wsprd_tpu.frontend.decimate import decimate_stage1_batched
    from rtlsdr_wsprd_tpu.frontend.filters import R1, STAGE1_TAPS

    n = 120
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, (2, 2, n * R1 + STAGE1_TAPS - R1),
                       dtype=np.uint8)
    (mI, mQ), _ = smoke.ref_frontend(raw[0], raw[1], n)
    got = decimate_stage1_batched(jnp.asarray(raw[0]), jnp.asarray(raw[1]),
                                  n)
    assert smoke.rel_err(got, (mI, mQ)) <= smoke.TOL["HIGHEST"]


def test_ref_frontend_matches_fused_step(smoke):
    from rtlsdr_wsprd_tpu.frontend.decimate import _fused_frontend_step
    from rtlsdr_wsprd_tpu.frontend.filters import R1, STAGE1_TAPS, STAGE2_TAPS

    n = 2000  # enough stage-1 frames for stage-2 output past the carry
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 256, (2, 2, n * R1 + STAGE1_TAPS - R1),
                       dtype=np.uint8)
    _, (oI, oQ) = smoke.ref_frontend(raw[0], raw[1], n)
    carry = jnp.zeros((2, STAGE2_TAPS // 2), jnp.float32)
    got = _fused_frontend_step(jnp.asarray(raw[0]), jnp.asarray(raw[1]),
                               carry, carry, n)
    assert oI.shape == got[0].shape == (2, 11)
    assert smoke.rel_err(got[:2], (oI, oQ)) <= smoke.TOL["HIGHEST"]


def test_ref_spectrogram_matches_stft(smoke):
    from rtlsdr_wsprd_tpu.ops.stft import power_spectrogram

    from bench import make_batch

    wi, wq = make_batch(1)
    ref = smoke.ref_spectrogram(wi[0], wq[0])
    got = power_spectrogram(jnp.asarray(wi[0]), jnp.asarray(wq[0]))
    assert ref.shape == got.shape == (512, 347)
    assert smoke.rel_err([got], [ref]) <= smoke.TOL["HIGHEST"]


def test_ref_coarse_grid_matches_coarse(smoke):
    from rtlsdr_wsprd_tpu.ops import coarse
    from rtlsdr_wsprd_tpu.ops.stft import power_spectrogram

    from bench import make_batch

    wi, wq = make_batch(1)
    ps = np.asarray(power_spectrogram(jnp.asarray(wi[0]),
                                      jnp.asarray(wq[0])))
    rows = slice(coarse.ROW_LO, coarse.ROW_HI + 1)
    ss_ref, pw_ref = smoke.ref_coarse_grid(ps, rows)
    ss, pw = coarse.coarse_grid(jnp.asarray(ps))
    assert ss_ref.shape == (423, 32, 9)
    err = smoke.rel_err([np.asarray(ss)[rows], np.asarray(pw)[rows]],
                        [ss_ref, pw_ref])
    assert err <= smoke.TOL["HIGHEST"]


def test_parse_daemon_spots_reads_the_spot_lines(smoke):
    from rtlsdr_wsprd_tpu.models.decoder import Spot
    from rtlsdr_wsprd_tpu.runtime.reporting import format_spot_line

    spot = Spot(freq=14.097, sync=0.5, snr=-12.0, dt=0.3, drift=0.0,
                jitter=0, message="K1JT FN20 20", call="K1JT", loc="FN20",
                pwr="20", cycles=100)
    gtm = time.gmtime(0)
    text = "\n".join([
        "-- channel 0", format_spot_line(spot, gtm),
        "-- channel 2", format_spot_line(spot, gtm),
        format_spot_line(spot, gtm),
        "Processed 1 window batch(es), 4 channel-windows, 3 spot(s), "
        "0 error(s)."])
    per, processed = smoke.parse_daemon_spots(text)
    assert per == {0: ["K1JT FN20 20"], 2: ["K1JT FN20 20"] * 2}
    assert processed.endswith("0 error(s).")


def test_census_truth_matches_make_batch_messages(smoke):
    """The smoke's ground truth is what bench.make_batch transmits:
    two messages per window, every 4th window noise-only."""
    truth = smoke.census_truth(8)
    assert truth[3] == truth[7] == set()
    assert truth[0] == {"K1JT FN20 37", "K9AN EN50 33"}
    assert all(len(t) == 2 for b, t in enumerate(truth) if b % 4 != 3)


def test_compile_cache_honours_environment(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the one cache directory."""
    import jax

    from rtlsdr_wsprd_tpu import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.cache_dir() == str(tmp_path)
        assert compile_cache.enable() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_default_is_the_checkouts(monkeypatch):
    """Unset, the cache is <checkout>/.jax_cache: a fixed path inside
    the checkout that git ignores."""
    from rtlsdr_wsprd_tpu import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.cache_dir() == want
    assert str(compile_cache.DEFAULT_DIR) == want
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
