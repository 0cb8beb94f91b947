"""On the card only: the fp8 control at a cell's own size comes out not
correct, on three seeds, where the program's served tokens are within the
limit (``control.py``; the readings in PERF.md)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_the_control_fails_the_long_prompt_cell(card):
    proc = subprocess.run(
        [sys.executable, "h100_bench/control.py", "--workload",
         "minicpm2b.long_prompt", "--seconds", "3", "--seeds",
         str(2 ** 31 + 301), str(2 ** 31 + 302), str(2 ** 31 + 303)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200, check=True)
    limit = json.loads((ROOT / "h100_bench" / "limits" /
                        "minicpm2b.long_prompt.json").read_text())
    for line in proc.stdout.splitlines():
        r = json.loads(line)
        assert r["program_gap"] <= limit["max_logit_gap"] < r["control_gap"]
