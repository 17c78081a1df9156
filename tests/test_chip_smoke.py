"""chip_smoke.py: its device check, and every phase at a tiny size on the
CPU (the same functions the script runs at full size on the GPU)."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs
from hash_join_codes_knl_tpu.engine.oracle import oracle_digest
from hash_join_codes_knl_tpu.relgen.generate import generate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NI, NO = 2000, 32000


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_device_check_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.device_check(1)


def test_script_exits_nonzero_on_cpu():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 2
    assert '"ok": true' not in r.stdout


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 2
    assert '"ok": true' not in r.stdout


@pytest.fixture(scope="module")
def uniform():
    inner, outer, _ = generate(7, NI, NO, mode="uniform",
                               prefer_native=False)
    return inner, outer, oracle_digest(inner.keys, inner.vals, outer.keys,
                                       outer.vals)


@pytest.mark.parametrize("zipf", [0.0, 1.0])
def test_main_path_phase(zipf):
    rec, (inner, outer, want) = cs.main_path(NI, NO, zipf, "cpu", None,
                                             seed=5, reps=1)
    assert rec["ok"], rec
    assert rec["digest"] == want
    assert rec["memory_analysis"]
    assert len(rec["warm_s"]) == 1


def test_npj_phase(uniform):
    assert cs.npj_phase(*uniform, None)["ok"]


def test_grace_phase(uniform):
    assert cs.grace_phase(*uniform, None)["ok"]


def test_stream_phase(uniform):
    rec = cs.stream_phase(*uniform, NO // 4, None)
    assert rec["ok"] and rec["chunks"] == 4


def test_radix_pass_phase(uniform):
    _, outer, _ = uniform
    rec = cs.radix_pass_phase(outer.keys[:5000], outer.vals[:5000])
    assert rec["ok"] and rec["overflow"] == 0


def test_padded_radix_and_aggregate_phases():
    rec, out = cs.padded_radix_phase(1000, 8000, None, seed=3)
    assert rec["ok"], rec
    assert cs.aggregate_phase(*out)["ok"]


def test_mn_phase():
    rec = cs.mn_phase(300, 3000, None, seed=4)
    assert rec["ok"] and rec["digest"][0] > 3000  # genuinely M:N


@pytest.fixture(scope="module")
def mesh4():
    from hash_join_codes_knl_tpu.parallel.distributed import data_mesh

    return data_mesh(4)


@pytest.mark.parametrize("pack", ["sort", "radix"])
def test_cpra_phases(mesh4, uniform, pack):
    assert cs.cpra_digest_phase(mesh4, *uniform, pack, None)["ok"]
    rel = cs.cardinality_relations(4 * NI, 4 * NO)
    rec = cs.cpra_cardinality_phase(mesh4, rel, pack)
    assert rec["ok"] and rec["join_tuples"] == 4 * NO


def test_npj_dist_phase(mesh4, uniform):
    assert cs.npj_dist_phase(mesh4, *uniform, None)["ok"]


def test_grace_dist_phase(mesh4, uniform):
    assert cs.grace_dist_phase(mesh4, *uniform, None)["ok"]


def test_exchange_phase(mesh4, uniform):
    inner, outer, _ = uniform
    rec = cs.exchange_phase(mesh4, inner, outer, "cpu", reps=1)
    assert rec["ok"] and len(rec["exchange_s"]) == 1


@pytest.mark.chip
def test_smoke_on_gpu(gpu_env):
    """Every single-GPU phase at 1/64 of the full size on the card."""
    code = ("import chip_smoke as cs; "
            "ok = cs.run_one_gpu(cs.device_check(1), None, scale=64); "
            "raise SystemExit(0 if ok else 1)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=gpu_env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
