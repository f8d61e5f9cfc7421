"""Checkpoint/resume subsystem tests (new capability; the reference has no
simulation checkpointing — SURVEY.md §5.4)."""
import os

import numpy as np
import pytest

from opticomlib_tpu.ops import ssfm
from opticomlib_tpu.runtime import (
    PropagationCheckpointer, ssfm_propagate_resumable,
)


def _wgrid(n, fs):
    return 2 * np.pi * np.fft.fftfreq(n) * fs


def _input(n=2048, fs=160e9):
    rng = np.random.default_rng(0)
    from scipy.ndimage import gaussian_filter1d
    bits = rng.integers(0, 2, n // 16).astype(float)
    return gaussian_filter1d(np.repeat(bits, 16), 4).astype(np.complex64) * 0.2


def test_checkpointer_roundtrip(tmp_path):
    ck = PropagationCheckpointer(str(tmp_path), config={"a": 1})
    re = np.arange(16, dtype=np.float32)
    im = -re
    ck.save(1, 10.0, re, im, extra={"note": "seg1"})
    step, z, re2, im2, extra = ck.latest()
    assert step == 1 and z == 10.0
    np.testing.assert_array_equal(re2, re)
    np.testing.assert_array_equal(im2, im)
    assert extra["note"] == "seg1"


def test_checkpointer_prunes_and_keeps_latest(tmp_path):
    ck = PropagationCheckpointer(str(tmp_path), config={}, keep=2)
    for s in range(1, 5):
        ck.save(s, float(s), np.zeros(4, np.float32), np.zeros(4, np.float32))
    files = [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    assert len(files) == 2
    assert ck.latest()[0] == 4


def test_checkpointer_rejects_config_mismatch(tmp_path):
    ck = PropagationCheckpointer(str(tmp_path), config={"gamma": 1.3})
    ck.save(1, 1.0, np.zeros(4, np.float32), np.zeros(4, np.float32))
    ck2 = PropagationCheckpointer(str(tmp_path), config={"gamma": 2.0})
    with pytest.raises(ValueError):
        ck2.latest()


def test_checkpointer_survives_corrupt_latest(tmp_path):
    ck = PropagationCheckpointer(str(tmp_path), config={})
    ck.save(1, 1.0, np.ones(4, np.float32), np.zeros(4, np.float32))
    ck.save(2, 2.0, 2 * np.ones(4, np.float32), np.zeros(4, np.float32))
    # simulate a crash that truncated the newest file
    newest = os.path.join(str(tmp_path), "ckpt_00000002.npz")
    with open(newest, "wb") as f:
        f.write(b"garbage")
    step, z, re, im, _ = ck.latest()
    assert step == 1 and z == 1.0


def test_resumable_matches_straight_run(tmp_path):
    A = _input()
    w = _wgrid(A.size, 160e9)
    kw = dict(alpha=0.2, beta_2=-20, gamma=1.3, h=0.5)

    straight = np.asarray(ssfm.ssfm_propagate(A, w, length=4.0, **kw))

    d1 = str(tmp_path / "run")
    out = ssfm_propagate_resumable(A, w, length=4.0, ckpt_dir=d1,
                                   segment_km=1.0, **kw)
    np.testing.assert_allclose(out, straight, atol=1e-5)

    # simulate crash after 2 segments: rerun from existing ckpt_dir
    ck = PropagationCheckpointer(d1, config=dict(
        length=4.0, alpha=0.2, beta_2=-20, beta_3=0.0, gamma=1.3, h=0.5,
        phi_max=0.01, segment_km=1.0, n=A.size))
    # drop to the z=2 checkpoint by deleting later ones
    for f in sorted(os.listdir(d1)):
        if f > "ckpt_00000002.npz":
            os.unlink(os.path.join(d1, f))
    resumed = ssfm_propagate_resumable(A, w, length=4.0, ckpt_dir=d1,
                                       segment_km=1.0, **kw)
    np.testing.assert_allclose(resumed, straight, atol=1e-5)


def test_span_chain_resumable_bitexact(tmp_path):
    """Kill-and-resume at a span boundary of a per-span fused chain
    (SSFM + gain + keyed ASE) reproduces the uninterrupted run
    bit-for-bit (VERDICT round-2 item 7)."""
    import jax
    import jax.numpy as jnp

    from opticomlib_tpu.ops import ssfm
    from opticomlib_tpu.ops.noise import gaussian_inside
    from opticomlib_tpu.runtime.checkpoint import (PropagationCheckpointer,
                                                   span_chain_resumable)

    n, fs, span_L = 2048, 160e9, 5.0
    w = 2 * np.pi * np.fft.fftfreq(n) * fs
    phi_w = jnp.asarray(ssfm.dispersion_phase(w, -21.0, 0.0))
    hs = jnp.asarray(ssfm.ssfm_step_schedule(span_L, 0.5))
    base = jax.random.PRNGKey(42)

    @jax.jit
    def span_prog(re, im, idx):
        # one whole span in-graph: SSFM scan + gain + keyed per-span ASE
        A = ssfm.ssfm_scan_inside(jax.lax.complex(re, im), phi_w, hs,
                                  1.3, ssfm.alpha_per_km(0.2))
        A = A * jnp.float32(10 ** (0.2 * span_L / 20))
        d = gaussian_inside(jax.random.fold_in(base, idx), (2, n), 1e-4)
        A = A + jax.lax.complex(d[0], d[1])
        return A.real, A.imag

    def apply_span(A, s):
        re, im = span_prog(jnp.asarray(A.real), jnp.asarray(A.imag),
                           jnp.uint32(s))
        return np.asarray(re) + 1j * np.asarray(im)

    rng = np.random.default_rng(1)
    A0 = (rng.normal(size=n) + 1j * rng.normal(size=n)
          ).astype(np.complex64) * 0.1
    cfg = dict(physics="test-span")

    full = span_chain_resumable(A0, apply_span, 4,
                                str(tmp_path / "full"), cfg)

    crash_dir = str(tmp_path / "crash")
    orig = PropagationCheckpointer.save
    calls = {"n": 0}

    def dying(self, *a, **kw):
        out = orig(self, *a, **kw)
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("boom")
        return out

    PropagationCheckpointer.save = dying
    try:
        with pytest.raises(RuntimeError, match="boom"):
            span_chain_resumable(A0, apply_span, 4, crash_dir, cfg)
    finally:
        PropagationCheckpointer.save = orig

    resumed = span_chain_resumable(A0, apply_span, 4, crash_dir, cfg)
    np.testing.assert_array_equal(resumed, full)


@pytest.fixture
def restore_cache_config():
    """Put the process-wide cache settings back after a test moves them."""
    import jax

    from opticomlib_tpu.runtime import cache as rc

    saved = (jax.config.jax_compilation_cache_dir, rc._enabled_dir)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    rc._enabled_dir = saved[1]


def test_enable_cache_env_handling(tmp_path, monkeypatch,
                                   restore_cache_config):
    """on/off-style env values select/refuse the default dir; a path
    value becomes the cache dir (round-3 review fix).  JAX's own
    variable is unset here; it wins over all of these (next test)."""
    import jax

    from opticomlib_tpu.runtime import cache as rc

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = tmp_path / "xla"
    monkeypatch.setattr(rc, "DEFAULT_CACHE_DIR", str(tmp_path / "default"))

    # explicit dir
    got = rc.enable_cache(str(d))
    assert got == str(d) and d.is_dir()
    assert rc.cache_dir() == str(d)
    assert jax.config.jax_compilation_cache_dir == str(d)

    # env path
    monkeypatch.setenv("OPTICOMLIB_TPU_CACHE", str(tmp_path / "envdir"))
    assert rc.enable_cache().endswith("envdir")

    # on-style values (any casing) -> default dir, never a dir literally
    # named 'true'/'ON'/'Yes'
    for v in ("1", "true", "yes", "ON", "Yes", "TRUE", " on "):
        monkeypatch.setenv("OPTICOMLIB_TPU_CACHE", v)
        assert rc.enable_cache() == str(tmp_path / "default")

    # off-style values (any casing) in the import hook -> no call
    calls = []
    monkeypatch.setattr(rc, "enable_cache", lambda *a, **k: calls.append(1))
    for v in ("0", "false", "off", "OFF", "No", "FALSE"):
        monkeypatch.setenv("OPTICOMLIB_TPU_CACHE", v)
        rc._maybe_enable_from_env()
    assert not calls
    # unset/empty -> DEFAULT-ON (round-4: cache enabled out of the box)
    for v in ("", "1"):
        monkeypatch.setenv("OPTICOMLIB_TPU_CACHE", v)
        rc._maybe_enable_from_env()
    monkeypatch.delenv("OPTICOMLIB_TPU_CACHE")
    rc._maybe_enable_from_env()
    assert calls == [1, 1, 1]


def test_checkpointer_shard_isolation(tmp_path):
    """Round-3 review fix: a shard=None checkpointer must neither see nor
    prune sharded files in the same directory (and vice versa)."""
    import numpy as np

    from opticomlib_tpu.runtime.checkpoint import PropagationCheckpointer

    d = str(tmp_path)
    cfg = {"k": 1}
    sh = PropagationCheckpointer(d, config=cfg, shard=0)
    sh.save(49, 1.0, np.zeros(4), np.zeros(4))
    sh.save(50, 2.0, np.zeros(4), np.zeros(4))

    un = PropagationCheckpointer(d, config=cfg)
    assert un._steps() == []                    # sharded files invisible
    un.save(1, 0.5, np.ones(4), np.zeros(4))
    assert un._steps() == [1]                   # own save survives prune
    st = un.latest()
    assert st is not None and st[0] == 1
    # sharded side still intact and isolated
    assert sh._steps() == [49, 50]


def test_resumable_rejects_different_frequency_grid(tmp_path):
    """Round-3 review fix: resuming with the same n but a different fs
    (different w grid) is rejected via the config fingerprint."""
    import numpy as np
    import pytest

    from opticomlib_tpu.runtime.checkpoint import ssfm_propagate_resumable

    n = 128
    A = (np.random.default_rng(0).standard_normal(n)
         * 0.1).astype(np.complex64)
    w1 = 2 * np.pi * np.fft.fftfreq(n) * 640e9
    w2 = 2 * np.pi * np.fft.fftfreq(n) * 320e9
    d = str(tmp_path)
    # every config field identical between the two calls EXCEPT the w
    # grid, so the ValueError can only come from the w_grid fingerprint
    # entry (round-4 advisor fix: varying length too would trip the
    # fingerprint even without the w_grid entry)
    ssfm_propagate_resumable(A, w1, 2.0, d, 1.0, alpha=0.2,
                             beta_2=-21.0, gamma=1.3, h=0.5)
    with pytest.raises(ValueError, match="different"):
        ssfm_propagate_resumable(A, w2, 2.0, d, 1.0, alpha=0.2,
                                 beta_2=-21.0, gamma=1.3, h=0.5)


def test_jax_cache_env_wins_over_enable_cache(tmp_path, monkeypatch,
                                              restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, no argument or package
    variable moves the cache elsewhere, and the package's opt-out does
    not turn it off."""
    import jax

    from opticomlib_tpu.runtime import cache as rc

    env_dir = str(tmp_path / "from_env")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    monkeypatch.setenv("OPTICOMLIB_TPU_CACHE", str(tmp_path / "pkg"))
    assert rc.enable_cache(str(tmp_path / "arg")) == env_dir
    assert rc.enable_cache() == env_dir
    assert jax.config.jax_compilation_cache_dir == env_dir
    assert rc.cache_dir() == env_dir
    assert not (tmp_path / "arg").exists()
    assert not (tmp_path / "pkg").exists()

    calls = []
    monkeypatch.setattr(rc, "enable_cache", lambda *a, **k: calls.append(1))
    monkeypatch.setenv("OPTICOMLIB_TPU_CACHE", "0")
    rc._maybe_enable_from_env()
    assert calls == [1]


@pytest.mark.parametrize("entry", ["bench.py", "chip_smoke.py"])
def test_entry_points_keep_jax_cache_env(tmp_path, entry):
    """bench.py and chip_smoke.py set no cache directory of their own:
    they only import the package, which keeps JAX_COMPILATION_CACHE_DIR."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = open(os.path.join(root, entry)).read()
    assert "enable_cache(" not in src
    assert "compilation_cache_dir" not in src
    env_dir = str(tmp_path / "jaxcache")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=env_dir,
               JAX_PLATFORMS="cpu", OPTICOMLIB_TPU_CACHE="0")
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, opticomlib_tpu as o; "
         "print(jax.config.jax_compilation_cache_dir); print(o.cache_dir())"],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [env_dir, env_dir]


def test_default_cache_dir_is_fixed_inside_checkout():
    """Unset JAX_COMPILATION_CACHE_DIR: the cache lives at <repo>/.jax_cache,
    a fixed path listed in .gitignore."""
    from opticomlib_tpu.runtime import cache as rc

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert rc.DEFAULT_CACHE_DIR == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
