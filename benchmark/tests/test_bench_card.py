"""A short run of a cell on the card, as the benchmark's command runs it
(skips without a card)."""

import json
import os
import subprocess
import sys

import pytest

import benchutil


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_a_short_encode_run_on_the_card(card):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "diploid1m_ont60.encode", "--seed", str(2**31 + 3), "--seconds",
         "1", "--trace", "0"], cwd=benchutil.ROOT, capture_output=True,
        text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], p.stderr[-3000:]
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]["reads_encoded_per_s"]["value"] > 0
    assert os.path.exists(os.path.join(benchutil.ROOT, "BENCHMARK.json"))
