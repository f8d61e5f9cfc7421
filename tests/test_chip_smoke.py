"""chip_smoke.py: it refuses to run without a GPU, and its phase
functions run at small sizes on the CPU (the four-device phases on four
of the virtual CPU devices).  On a GPU the tests marked ``chip`` run the
single-card phases at small sizes there."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("args", [[], ["--four"]])
def test_exits_nonzero_without_gpu(args):
    r = _run(args, ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not a GPU" in r.stderr


def test_exits_nonzero_alone(tmp_path):
    """Copied away from the repository, the script cannot import the
    program and must fail without a result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run([], tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _json_safe(res):
    json.dumps(res)   # every phase result must print as one JSON line
    return res


SMALL = {
    "staged": dict(Ns=(2**6,)),
    "fused": dict(n_bits=2**10, sps=16),
    "reference": dict(n=2**12, length=20.0),
    "fft_len": dict(n_bits=64, sps=8, fir_taps=33),
    "step": dict(n=2**12, iters=3),
    "complex_io": dict(),
}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_single_card_phase_small(name):
    assert set(SMALL) == set(cs.PHASES_ONE)
    res = _json_safe(cs.PHASES_ONE[name](**SMALL[name]))
    if name == "reference":
        for scheme in ("reference", "o4"):
            assert res[scheme]["rel_l2_device"] <= res[scheme]["bound"]
            assert res[scheme]["rel_l2_device"] < 1e-4
    if name == "fused":
        assert res["ber"] == 0.0 and res["ssfm_steps"] > 10


SMALL_FOUR = {
    "time_sharded": dict(n_bits=2**11, sps=16),
    "wdm_sharded": dict(n_bits=2**10, sps=16),
    "span_pipeline": dict(n_bits=2**10, sps=8),
}


@pytest.mark.parametrize("name", sorted(SMALL_FOUR))
def test_four_device_phase_small(name):
    assert set(SMALL_FOUR) == set(cs.PHASES_FOUR)
    res = _json_safe(cs.PHASES_FOUR[name](**SMALL_FOUR[name]))
    assert all(b == 0.0 for b in np.ravel(res.get("ber", res.get(
        "ber_sharded"))))


@pytest.mark.chip
@pytest.mark.parametrize("name", ["reference", "fft_len", "complex_io",
                                  "staged"])
def test_gpu_phase_small(gpu, name):
    _json_safe(cs.PHASES_ONE[name](**SMALL[name]))
