"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference, the traffic generator and the count load nothing of the
program.  Top-level module names are compared whole: ``repro_torch``
begins with ``repro``.  Each check runs in a fresh interpreter, since the
test process itself imports both packages."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PROBE = """
import json, sys
for name in sys.argv[1:]:
    __import__(name)
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""


def _top_level(*modules) -> set:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]))
    proc = subprocess.run([sys.executable, "-c", PROBE, *modules], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300, check=True)
    return set(json.loads(proc.stdout.splitlines()[-1]))


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    names = _top_level("h100_bench.harness", "h100_bench.control",
                       "repro_torch.serving.engine",
                       "repro_torch.models.transformer")
    assert "repro_torch" in names and "h100_bench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("module", ["h100_bench.reference",
                                    "h100_bench.traffic",
                                    "h100_bench.count"])
def test_the_yardstick_loads_nothing_of_the_program(module):
    names = _top_level(module)
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
