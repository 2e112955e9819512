"""Twins of tests/integration/test_configs.py's TestConfig3 and TestConfig4
(an 8-process gloo world) and of tests/integration/test_multihost.py (the
port's config drivers under ``torchrun --standalone --nproc-per-node=4``
on the CPU with ``--check``)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_dist_workers
from audiosignalprocess_tpu.cpu_ref import oracle
from audiosignalprocess_tpu_torch.ops.fir import design_fir
from audiosignalprocess_tpu_torch.parallel import spawn_local
from audiosignalprocess_tpu_torch.tools.common import make_signal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tone_noise(channels, rate, seconds):
    return make_signal(channels, rate, seconds).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    x3 = _tone_noise(8, 48000, 1.0)
    x3 = x3[:, : (x3.shape[-1] // 256) * 256].astype(np.float64)
    x4 = _tone_noise(4, 96000, 1.0).astype(np.float64)
    x4 = x4[:, : (x4.shape[-1] // 8192) * 8192]
    h4 = design_fir(4096, 0.1, window_kind="blackman")
    cases = [("config3", "gate", (8, 1), {}, x3),
             ("config4", "overlap_save", (2, 4), dict(h=h4, nfft=16384), x4)]
    out = spawn_local(torch_dist_workers.run_cases, 8, args=(cases,), device="cpu",
                      timeout_s=240.0)[0]
    return dict(x3=x3, x4=x4, h4=h4), out


class TestConfig3:
    def test_channel_sharded_gate(self, world):
        x, out = world
        ref = np.stack([oracle.noise_gate(c) for c in x["x3"]])
        assert oracle.snr_db(ref, out["config3"][:, : ref.shape[-1]]) >= 60.0


class TestConfig4:
    def test_long_fir_halo(self, world):
        x, out = world
        ref = np.stack([oracle.fir_direct(c, x["h4"]) for c in x["x4"]])
        assert oracle.snr_db(ref, out["config4"]) >= 60.0


@pytest.mark.parametrize("config", ("3", "4"))
def test_torchrun_four_ranks(config):
    """The driver under torchrun, 4 CPU ranks over gloo, passes its own
    >= 60 dB check of the gathered output (on the JAX drivers' meshes:
    4x1 for both)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=4", "-m", f"audiosignalprocess_tpu_torch.tools.run_config_{config}",
         "--check", "--json", "--seconds", "1", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, f"stdout:\n{r.stdout[-2000:]}\nstderr:\n{r.stderr[-2000:]}"
    recs = [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith("{") and "snr_db_vs_f64_plain" in ln]
    assert recs and all(rec["parity"] and rec["ranks"] == 4 for rec in recs), r.stdout
