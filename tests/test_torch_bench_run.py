"""The reporting layer and the one driver: ``launch.perf``'s suites
(``tests/test_summarize_perf.py``'s checks, and equal to the reference's),
``launch.summarize`` and ``bench.roofline_report`` rendered from dry-run
artifacts the test writes, the CLIs' flags against the reference's (the
same ``add_argument`` flags plus ``--device``), and ``bench.run``: the
reference driver's sections in its order, each section given its own
argument list."""
import ast
import dataclasses
import json
from pathlib import Path

import pytest

from repro.launch.perf import SUITES as R_SUITES
from repro_torch.bench import cost_bench, paper_tables, roofline_report
from repro_torch.bench import run as RUN
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch import dryrun, perf, summarize
from repro_torch.launch.mesh import StandInMesh

ROOT = Path(__file__).resolve().parents[1]


def test_perf_suites_well_formed():
    fields = {f.name for f in dataclasses.fields(RunConfig)}
    for name, suite in perf.SUITES.items():
        assert "baseline" in suite or "legacy_shard" in suite, name
        for vname, overrides in suite.items():
            assert isinstance(overrides, dict)
            assert set(overrides) <= fields, (name, vname)
    assert perf.SUITES == R_SUITES


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Dry-run artifacts of two smoke cells on a (2, 2) stand-in, one per
    mesh name, and a failed cell; and a perf variant's artifact."""
    root = tmp_path_factory.mktemp("art")
    dd, pd = root / "dryrun", root / "perf"
    dd.mkdir()
    mesh = StandInMesh({"data": 2, "model": 2})
    for arch, name, mname in (("llama3.2-1b", "train_4k", "single"),
                              ("jamba-v0.1-52b", "decode_32k", "single"),
                              ("llama3.2-1b", "prefill_32k", "multi")):
        shape = dataclasses.replace(SHAPES[name], global_batch=4,
                                    seq_len=32)
        res = dryrun.lower_cell(arch, shape, mname == "multi",
                                verbose=False, mesh=mesh,
                                cfg=get_smoke_config(arch), device="cpu")
        Path(dryrun.artifact_path(str(dd), arch, name, mname)).write_text(
            json.dumps(res))
    Path(dryrun.artifact_path(str(dd), "gemma2-9b", "train_4k",
                              "single")).write_text(
        '{"arch": "gemma2-9b", "shape": "train_4k", "mesh": "single", '
        '"error": "Traceback"}')
    cfg = get_smoke_config("llama3.2-1b")
    orig = dryrun.get_config
    dryrun.get_config = lambda arch: cfg
    try:
        perf.run_variant("llama3.2-1b", "decode_32k", "baseline", {},
                         str(pd), device="cpu")
    finally:
        dryrun.get_config = orig
    return root


def test_summarize_renders(artifacts, capsys):
    md = summarize.dryrun_table(str(artifacts / "dryrun"))
    lines = md.splitlines()
    assert lines[0].startswith("| arch |") and len(lines) == 2 + 4
    assert any("FAILED" in l for l in lines)
    # an inference cell on a mesh counts the mesh step the port runs
    assert "| jamba-v0.1-52b | decode_32k | single |" in md
    assert "| llama3.2-1b | train_4k | single |" in md
    assert "modelled" not in md
    pt = summarize.perf_table(str(artifacts / "perf"))
    assert "llama3.2-1b × decode_32k | baseline |" in pt
    assert summarize.perf_table(str(artifacts / "none")) == \
        "(no perf artifacts)"
    summarize.main(["--dir", str(artifacts)])
    out = capsys.readouterr().out
    for head in ("## §Dry-run grid", "## §Roofline (single-pod)",
                 "## §Roofline (multi-pod)", "## §Perf variants"):
        assert head in out
    assert "fits 80G" in out and "fits 16G" not in out
    assert "| gemma2-9b | train_4k | ERROR" in out


def test_roofline_report_rows(artifacts, capsys, tmp_path):
    rows = roofline_report.rows(art_dir=str(artifacts / "dryrun"))
    names = [r["name"] for r in rows]
    assert names == ["roofline_gemma2-9b_train_4k",
                     "roofline_jamba-v0.1-52b_decode_32k",
                     "roofline_llama3.2-1b_train_4k"]
    assert rows[0] == {"name": names[0], "us_per_call": -1, "error": True}
    for r in rows[1:]:
        assert "fits_80g" in r and "fits_16g" not in r
        assert r["us_per_call"] > 0
    assert "decode_tokens_per_s" in rows[1]
    assert "decode_tokens_per_s" not in rows[2]
    assert "modelled" not in rows[1] and "modelled" not in rows[2]
    roofline_report.main(["--dir", str(artifacts / "dryrun")])
    out = capsys.readouterr().out.splitlines()
    assert [l.split(",")[0] for l in out] == names
    assert roofline_report.rows(art_dir=str(tmp_path / "none")) == []


def test_perf_main_fails_on_a_failed_variant(tmp_path, capsys):
    """A suite whose variant fails exits non-zero, as ``dryrun.main``
    does on a failed cell."""
    with pytest.raises(SystemExit) as e:
        perf.main(["--arch", "llama3.2-1b", "--shape", "train_4k",
                   "--variant", 'bad={"no_such_field": 1}', "--out",
                   str(tmp_path), "--device", "cpu"])
    assert e.value.code == "1 variants failed"
    assert "FAILED bad" in capsys.readouterr().out


def _flags(path: Path) -> set:
    """The option strings of every ``add_argument`` call in a file."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "add_argument":
            out |= {a.value for a in node.args
                    if isinstance(a, ast.Constant)}
    return out


@pytest.mark.parametrize("name", ["dryrun", "perf", "summarize"])
def test_cli_flags_are_the_reference_plus_device(name):
    ours = _flags(ROOT / "src" / "repro_torch" / "launch" / f"{name}.py")
    ref = _flags(ROOT / "src" / "repro" / "launch" / f"{name}.py")
    assert ours == ref | {"--device"}


def test_driver_sections_are_the_reference_order():
    tree = ast.parse((ROOT / "benchmarks" / "run.py").read_text())
    lists = [n for n in ast.walk(tree) if isinstance(n, ast.List)
             and n.elts and all(isinstance(e, ast.Constant)
                                for e in n.elts)]
    assert RUN.SECTIONS == tuple(e.value for e in lists[0].elts)


def test_driver_passes_each_section_its_own_arguments(monkeypatch):
    """Every section's ``main`` gets ``--device`` and nothing of the
    driver's ``sys.argv``; ``cost`` writes the port's ``--out``, never
    ``BENCH_cost.json``."""
    seen = {}
    from repro_torch.bench import (autotune, bank_scaling, beyond_paper,
                                   kernel_bench, serving_bench)
    for mod in (autotune, bank_scaling, beyond_paper, cost_bench,
                kernel_bench, paper_tables, roofline_report, serving_bench):
        monkeypatch.setattr(mod, "main", lambda argv, m=mod.__name__:
                            seen.setdefault(m, []).append(argv))
    monkeypatch.setattr("sys.argv", ["run", "--bogus"])
    RUN.main(["--device", "cpu"])
    flags = ["--device", "cpu"]
    assert seen["repro_torch.bench.paper_tables"] == [
        ["table2", *flags], ["table3", *flags], ["table1", *flags],
        ["fig9", *flags]]
    for m in ("autotune", "serving_bench", "cost_bench", "beyond_paper",
              "bank_scaling", "kernel_bench", "roofline_report"):
        assert seen[f"repro_torch.bench.{m}"] == [flags], m
    assert cost_bench.OUT_JSON == ROOT / "build" / "cost_bench.json"


def test_driver_table1_and_roofline(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(roofline_report, "ART", str(tmp_path / "none"))
    RUN.main(["table1", "roofline", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    paper_tables.main(["table1", "--device", "cpu"])
    table1 = capsys.readouterr().out.splitlines()
    assert out[0] == "# --- table1 ---" and len(table1) > 3
    assert out[1:1 + len(table1)] == table1
    assert out[1 + len(table1)] == "# --- roofline ---"
    assert out[2 + len(table1):] == []           # no artifacts, no rows


def test_accounting_runs_with_the_reference_blocked():
    """The dry run of a smoke cell and the driver's ``table1`` and
    ``roofline`` sections with JAX, ``repro`` and ``benchmarks`` blocked
    from import; ``lower_cell`` and the CLIs default to the card."""
    import inspect
    import os
    import subprocess
    import sys
    assert inspect.signature(dryrun.lower_cell).parameters[
        "device"].default == "cuda"
    script = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'ml_dtypes', 'repro', 'benchmarks'):\n"
        "    sys.modules[name] = None\n"
        "import dataclasses\n"
        "from repro_torch.bench.run import main\n"
        "from repro_torch.configs import SHAPES, get_smoke_config\n"
        "from repro_torch.launch.dryrun import lower_cell\n"
        "from repro_torch.launch.mesh import StandInMesh\n"
        "shape = dataclasses.replace(SHAPES['train_4k'], global_batch=4,\n"
        "                            seq_len=16)\n"
        "res = lower_cell('llama3.2-1b', shape, False, verbose=False,\n"
        "                 mesh=StandInMesh({'data': 2, 'model': 2}),\n"
        "                 cfg=get_smoke_config('llama3.2-1b'), device='cpu')\n"
        "assert res['full']['flops'] > 0\n"
        "main(['table1', 'roofline', '--device', 'cpu'])\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.',\n"
        "                                           'benchmarks.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('isolated ok')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "# --- table1 ---" in out.stdout and "isolated ok" in out.stdout


@pytest.mark.parametrize("mod", [dryrun, perf, summarize, RUN,
                                 roofline_report])
def test_cli_help(mod, capsys):
    """``--help`` exits 0 and names the flags (the counterpart of
    ``tests/test_launchers_cli.py::test_dryrun_cli_help``)."""
    with pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--device" in out
    if mod is dryrun:
        assert "--arch" in out and "--mesh" in out
