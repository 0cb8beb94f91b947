"""repro_torch stands alone: no module of the port imports JAX or the
reference package ``repro``, and a CPU smoke generation (through the
serving CLI) runs with both blocked from import."""
import ast
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_module_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f.relative_to(SRC)): sorted(_imported_roots(f)
                                           & {"jax", "jaxlib", "repro"})
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_cpu_serving_runs_with_jax_and_repro_blocked():
    script = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "from repro_torch.launch import serve\n"
        "serve.main(['--smoke', '--device', 'cpu', '--cost', '--batch', '2',"
        " '--prompt-len', '12', '--new-tokens', '4'])\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('isolated ok')\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "isolated ok" in out.stdout
    assert "16B" in out.stdout and "4R-2W" in out.stdout


def test_default_device_is_the_card():
    """Entry points default to CUDA: without a card they fail instead of
    running on the host."""
    import inspect

    import torch

    from repro_torch.core.cost_engine import cost_many
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.kvcache import simulate_serving_stream
    for fn in (ServeEngine.__init__, cost_many, simulate_serving_stream):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        import pytest
        with pytest.raises((RuntimeError, AssertionError)):
            cost_many(["16B"], simulate_serving_stream(
                "16B", 2, 8, 2, device="cpu"))
