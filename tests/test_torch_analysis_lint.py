"""The port's repo lint (repro_torch.analysis.lint) and its analysis CLI
(``python -m repro_torch.analysis``) held to the JAX reference's: a
counterpart of every case of ``tests/test_analysis_lint.py``, where each
rule's synthetic positive and its waivers give the reference's findings
(code, path, line and message), the whole ``src/`` tree and the port's
registries are clean, and a probe kernel without ``symbolic`` is flagged
REPRO003; then the CLI's printed lines and exit codes against the
reference CLI's, line for line, on the host (``--device cpu``)."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis import lint as RL
from repro_torch.analysis.lint import (Finding, lint_file, lint_paths,
                                       registry_findings, run_all)

SRC = Path(__file__).resolve().parent.parent / "src"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's host work on one thread (see
    ``_torch_train_parity.one_torch_thread``): the smoke models run many
    small ops, and under parallel test workers a thread pool per worker
    waits at every op for cores the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(findings):
    return [f.code for f in findings]


def _rows(findings):
    return [(f.code, f.path, f.line, f.message) for f in findings]


def _both(src, name="x.py"):
    """The port's findings on ``src``, after checking they are the
    reference's."""
    got = lint_file(name, source=src)
    assert _rows(got) == _rows(RL.lint_file(name, source=src))
    return got


# --------------------------------------------------------------------------
# REPRO001: dense materialize in library code
# --------------------------------------------------------------------------

def test_materialize_flagged_and_waived():
    src = (
        "t1 = stream.materialize()\n"
        "t2 = stream.materialize()  # lint: allow-materialize\n"
        "# lint: allow-materialize — deliberate dense view\n"
        "t3 = stream.materialize()\n"
    )
    fs = _both(src)
    assert _codes(fs) == ["REPRO001"] and fs[0].line == 1
    assert "STREAM_THRESHOLD" in fs[0].message


def test_materialize_waiver_covers_multiline_call():
    src = (
        "t = simulate(\n"
        "    arch, batch,\n"
        "    steps).materialize()  # lint: allow-materialize\n"
    )
    assert _both(src) == []


# --------------------------------------------------------------------------
# REPRO002: one-shot iterator handed to TraceStream
# --------------------------------------------------------------------------

def test_one_shot_generator_call_flagged():
    src = (
        "def gen():\n"
        "    yield 1\n"
        "s = TraceStream(gen())\n"
    )
    fs = _both(src)
    assert _codes(fs) == ["REPRO002"] and fs[0].line == 3


def test_iter_call_flagged():
    fs = _both("s = TraceStream(iter(blocks))\n")
    assert _codes(fs) == ["REPRO002"]


def test_one_shot_waiver_honored():
    src = (
        "def gen():\n"
        "    yield 1\n"
        "s = TraceStream(gen())  # lint: allow-one-shot-stream\n"
        "def outer():\n"
        "    def inner():\n"
        "        yield 2\n"
        "    return TraceStream(inner())\n"
    )
    fs = _both(src)
    assert _codes(fs) == ["REPRO002"] and fs[0].line == 7


def test_legal_tracestream_constructions_not_flagged():
    src = (
        "def gen():\n"
        "    yield 1\n"
        "def helper():\n"
        "    return [1]\n"
        "s1 = TraceStream(gen)\n"
        "s2 = TraceStream(lambda: gen())\n"
        "s3 = TraceStream([a, b])\n"
        "s4 = TraceStream(self._chunks(True))\n"
        "s5 = TraceStream(helper())\n"
    )
    assert _both(src) == []


# --------------------------------------------------------------------------
# REPRO005: bare except / swallowed exceptions
# --------------------------------------------------------------------------

def test_bare_except_flagged():
    src = (
        "try:\n"
        "    step()\n"
        "except:\n"
        "    log()\n"
    )
    fs = _both(src)
    assert _codes(fs) == ["REPRO005"] and fs[0].line == 3
    assert "bare" in fs[0].message


def test_swallowed_exception_flagged():
    src = (
        "try:\n"
        "    step()\n"
        "except ValueError:\n"
        "    pass\n"
        "try:\n"
        "    step()\n"
        "except OSError:\n"
        "    ...\n"
    )
    fs = _both(src)
    assert _codes(fs) == ["REPRO005", "REPRO005"]
    assert [f.line for f in fs] == [3, 7]
    assert "swallowed" in fs[0].message


def test_handled_exceptions_not_flagged():
    src = (
        "try:\n"
        "    step()\n"
        "except RuntimeError as e:\n"
        "    log.warning('retry: %s', e)\n"
        "except ValueError:\n"
        "    raise\n"
        "try:\n"
        "    v = parse(s)\n"
        "except KeyError:\n"
        "    v = default\n"
    )
    assert _both(src) == []


def test_silent_except_waiver_honored():
    src = (
        "try:\n"
        "    cleanup()\n"
        "except OSError:  # lint: allow-silent-except\n"
        "    pass\n"
        "# lint: allow-silent-except — best-effort teardown\n"
        "try:\n"
        "    close()\n"
        "except:\n"
        "    pass\n"
    )
    fs = _both(src)
    assert _codes(fs) == ["REPRO005"] and fs[0].line == 8


def test_silent_except_waiver_on_line_above_except():
    src = (
        "try:\n"
        "    close()\n"
        "# lint: allow-silent-except\n"
        "except:\n"
        "    pass\n"
    )
    assert _both(src) == []


# --------------------------------------------------------------------------
# REPRO006: per-block re-lowering; REPRO000: unparsable source
# --------------------------------------------------------------------------

def test_per_block_lowering_flagged_and_waived():
    src = (
        "for blk in trace.blocks(64):\n"
        "    c = cost_many(archs, blk)\n"
        "    for b in s.iter_blocks():\n"
        "        t = lower_archs(archs)\n"
        "for blk in trace.blocks(64):\n"
        "    c = cost_many(archs, blk)  # lint: allow-per-block-lowering\n"
        "for blk in blocks:\n"
        "    c = cost_many(archs, blk)\n"
    )
    fs = _both(src)
    assert _codes(fs) == ["REPRO006", "REPRO006"]
    assert [f.line for f in fs] == [2, 4]


def test_syntax_error_reported():
    fs = _both("def broken(:\n    pass\n")
    assert _codes(fs) == ["REPRO000"]


# --------------------------------------------------------------------------
# The shipped tree and registries are clean (the gate)
# --------------------------------------------------------------------------

def test_src_tree_is_lint_clean():
    assert lint_paths([str(SRC)]) == []
    assert lint_paths([str(SRC / "repro_torch")]) == []


def test_lint_paths_takes_files_and_trees(tmp_path):
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "a.py").write_text("x = s.materialize()\n")
    (tmp_path / "b.py").write_text("try:\n    f()\nexcept:\n    pass\n")
    paths = [str(tmp_path / "pkg"), str(tmp_path / "b.py")]
    got = lint_paths(paths)
    assert _codes(got) == ["REPRO001", "REPRO005"]
    assert _rows(got) == _rows(RL.lint_paths(paths))


def test_registries_are_clean():
    assert registry_findings() == []


def test_repro003_covers_model_registered_kernels():
    """A probe kernel missing its ``symbolic`` entry point is flagged,
    whatever module registered it."""
    from repro_torch.kernels import registry as kreg

    def _probe(arch, x):
        return x

    kreg.register(kreg.Kernel(name="_lint_gap_probe", cuda=_probe,
                              ref=_probe, trace=_probe, blocks=_probe,
                              symbolic=None))
    try:
        fs = [f for f in registry_findings()
              if f.path == "kernel:_lint_gap_probe"]
        assert _codes(fs) == ["REPRO003"]
        assert "symbolic" in fs[0].message
    finally:
        kreg._KERNELS.pop("_lint_gap_probe")
    assert registry_findings() == []


def test_every_port_kernel_has_all_three_entries():
    from repro_torch.kernels import registry as kreg
    for name in kreg.names():
        k = kreg.get(name)
        assert None not in (k.trace, k.blocks, k.symbolic), name


def test_repro004_flags_a_name_that_does_not_parse(monkeypatch):
    """A registered name the arch parser does not know is flagged, with the
    reference's finding."""
    from repro.core import arch as RA
    from repro_torch.core import arch as PA
    for mod in (PA, RA):
        names = mod.names()
        monkeypatch.setattr(mod, "names",
                            lambda names=names: names + ("bogus-arch",))
    got = [f for f in registry_findings() if f.code == "REPRO004"]
    assert _rows(got) == _rows([f for f in RL.registry_findings()
                                if f.code == "REPRO004"])
    assert [f.path for f in got] == ["arch:bogus-arch"]


def test_repro003_reaches_model_trace_module_without_prior_import():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "from repro_torch.analysis.lint import registry_findings\n"
        "assert registry_findings() == []\n"
        "from repro_torch.kernels import registry as kreg\n"
        "assert {'attn_decode', 'moe_a2a', 'ssm_scan'} <= set(kreg._KERNELS)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, timeout=300,
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin"})
    assert proc.returncode == 0, proc.stderr


def test_run_all_clean_on_repo():
    assert run_all((str(SRC),)) == []


def test_finding_str_is_clickable():
    f = Finding("REPRO001", "src/x.py", 7, "msg")
    assert str(f).startswith("src/x.py:7: REPRO001")
    assert str(Finding("REPRO004", "arch:16B", 0, "m")) == (
        "arch:16B: REPRO004 m")
    assert str(f) == str(RL.Finding("REPRO001", "src/x.py", 7, "msg"))


# --------------------------------------------------------------------------
# The CLI, line for line against the reference's
# --------------------------------------------------------------------------

def _cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("argv", [["--prove"], ["--check"],
                                  ["--lint", str(SRC)]])
def test_cli_lines_equal_the_reference(argv, capsys):
    from repro.analysis.__main__ import main as r_main
    from repro_torch.analysis.__main__ import main
    rc, lines = _cli(main, argv + ["--device", "cpu"], capsys)
    r_rc, r_lines = _cli(r_main, argv, capsys)
    assert (rc, lines) == (r_rc, r_lines)
    assert rc == 0 and lines[-1] == "analysis: OK"


def test_cli_without_a_pass_runs_all_three(capsys, monkeypatch):
    """``main(["--device", "cpu"])``: lint of ``src``, prove and check, the
    reference CLI's lines and exit code."""
    from repro.analysis.__main__ import main as r_main
    from repro_torch.analysis.__main__ import main
    monkeypatch.chdir(SRC.parent)
    rc, lines = _cli(main, ["--device", "cpu"], capsys)
    r_rc, r_lines = _cli(r_main, [], capsys)
    assert (rc, lines) == (r_rc, r_lines)
    assert rc == 0
    assert lines[0] == "lint: 0 finding(s) over src"
    assert sum(ln.startswith("prove: ") for ln in lines) == 10
    assert sum(ln.startswith("check: ") for ln in lines) == 25
    assert lines[-1] == "analysis: OK"


def test_cli_fails_on_a_finding(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("try:\n    f()\nexcept:\n    pass\n")
    from repro.analysis.__main__ import main as r_main
    from repro_torch.analysis.__main__ import main
    rc, lines = _cli(main, ["--lint", str(bad), "--device", "cpu"], capsys)
    r_rc, r_lines = _cli(r_main, ["--lint", str(bad)], capsys)
    assert (rc, lines) == (r_rc, r_lines)
    assert rc == 1 and lines[-1] == "analysis: 1 failure(s)"
