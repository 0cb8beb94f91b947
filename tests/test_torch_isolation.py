"""repro_torch stands alone: no module of the port (nor chip_smoke.py)
imports JAX, the reference package ``repro`` or the reference's
``benchmarks``, and a CPU smoke generation (through the serving CLI; a
hybrid model's too), the
Table I, Table II and Fig 9 CLI sections, the kernel micro-bench CLI, the
autotune CLI, the cost bench, a scheduled serving day (``serve
--schedule``), a faulted one (bank loss, page recovery, transient
retries; ``serve --fault-bank``), the serving bench's ``--check`` and
``--chaos --check``, a preempted and resumed day, the model-traffic
bench's ``--smoke --check``, the quickstart, training (the train CLI
and the train example; a hybrid model's train step), the analysis CLI
(lint, prove and check on the host) and an online tuner over a smoke
generation run with all three blocked from import."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

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


FORBIDDEN = {"jax", "jaxlib", "ml_dtypes", "repro", "benchmarks"}


def test_no_port_module_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [SRC.parent / "chip_smoke.py"]
    assert len(files) > 40
    bad = {str(f): sorted(_imported_roots(f) & FORBIDDEN) for f in files}
    assert not {k: v for k, v in bad.items() if v}


def _run_blocked(body: str) -> subprocess.CompletedProcess:
    """Run ``body`` in a fresh interpreter with the reference blocked."""
    script = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'ml_dtypes', 'repro', 'benchmarks'):\n"
        "    sys.modules[name] = None\n"
        + body +
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.',\n"
        "                                           'benchmarks.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('isolated ok')\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    return subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)


def test_table2_cli_runs_with_the_reference_blocked():
    """``python -m repro_torch.bench.paper_tables --device cpu table2``,
    run as ``-m`` runs it, with JAX, ``repro`` and ``benchmarks`` blocked."""
    out = _run_blocked(
        "import runpy\n"
        "sys.argv = ['paper_tables', '--device', 'cpu', 'table2']\n"
        "runpy.run_module('repro_torch.bench.paper_tables',\n"
        "                 run_name='__main__', alter_sys=True)\n")
    assert out.returncode == 0, out.stderr
    assert "isolated ok" in out.stdout
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("transp")]
    assert len(lines) == 24
    assert "transpose128_16B,33.835,total=26087|" in out.stdout


@pytest.mark.parametrize("section,count,first", [
    ("table1", 6, "simt_core_16sp,0,alms=7113|m20k=34|dsp=32"),
    ("fig9", 24, "fig9_64KB_4R-1W,64.24124513618678,footprint_alms=18286|"
                 "norm_perf=0.911|perf_per_area=0.85")])
def test_table1_and_fig9_clis_run_with_the_reference_blocked(section, count,
                                                             first):
    """``python -m repro_torch.bench.paper_tables --device cpu table1`` (and
    ``fig9``), run as ``-m`` runs it, with JAX, ``repro`` and
    ``benchmarks`` blocked."""
    out = _run_blocked(
        "import runpy\n"
        f"sys.argv = ['paper_tables', '--device', 'cpu', '{section}']\n"
        "runpy.run_module('repro_torch.bench.paper_tables',\n"
        "                 run_name='__main__', alter_sys=True)\n")
    assert out.returncode == 0, out.stderr
    assert "isolated ok" in out.stdout
    lines = [ln for ln in out.stdout.splitlines() if "," in ln]
    assert len(lines) == count
    assert lines[0] == first


def test_autotune_cli_runs_with_the_reference_blocked():
    """``python -m repro_torch.bench.autotune --smoke --device cpu``, run as
    ``-m`` runs it, with JAX, ``repro`` and ``benchmarks`` blocked: the
    transpose and serving cases, each strategy finding its expected
    winner."""
    out = _run_blocked(
        "import runpy\n"
        "sys.argv = ['autotune', '--smoke', '--device', 'cpu']\n"
        "runpy.run_module('repro_torch.bench.autotune',\n"
        "                 run_name='__main__', alter_sys=True)\n")
    assert out.returncode == 0, out.stderr
    assert "isolated ok" in out.stdout
    lines = [ln for ln in out.stdout.splitlines() if "," in ln]
    assert [ln.split(",")[0] for ln in lines] == [
        "autotune_transpose32_exhaustive", "autotune_transpose32_hillclimb",
        "autotune_serve_b4_p16_d8_exhaustive",
        "autotune_serve_b4_p16_d8_hillclimb"]
    assert all("|match=True|" in ln for ln in lines)


def test_kernel_bench_cli_runs_with_the_reference_blocked():
    """``python -m repro_torch.bench.kernel_bench --device cpu``, run as
    ``-m`` runs it, with JAX, ``repro`` and ``benchmarks`` blocked: its rows
    are all six of the reference bench's (``benchmarks/kernel_bench.py``),
    in the reference's order."""
    out = _run_blocked(
        "import runpy\n"
        "sys.argv = ['kernel_bench', '--device', 'cpu']\n"
        "runpy.run_module('repro_torch.bench.kernel_bench',\n"
        "                 run_name='__main__', alter_sys=True)\n")
    assert out.returncode == 0, out.stderr
    assert "isolated ok" in out.stdout
    rows = [ln.split(",") for ln in out.stdout.splitlines() if "," in ln]
    # the reference's row names: each ``out.append((name, ...))`` of its
    # ``rows()``, read from the source (the file imports JAX)
    tree = ast.parse((SRC.parent / "benchmarks" / "kernel_bench.py")
                     .read_text())
    reference = [node.args[0].elts[0].value for node in ast.walk(tree)
                 if isinstance(node, ast.Call)
                 and isinstance(node.func, ast.Attribute)
                 and node.func.attr == "append"
                 and isinstance(node.args[0], ast.Tuple)]
    assert "moe_dispatch_8192req_e16" in reference and len(reference) == 6
    assert [r[0] for r in rows] == reference
    assert all("|err=0.0|" in r[2] for r in rows)


def test_cost_bench_runs_with_the_reference_blocked(tmp_path):
    """``repro_torch.bench.cost_bench``'s rows (the transpose32 case, the
    pipelined stream, the warm cache over the two-level registry and the
    256² construction) and its CLI's check, with JAX, ``repro`` and
    ``benchmarks`` blocked; the rows stay bit-equal and on the reference's
    16B pins."""
    out = _run_blocked(
        "from repro_torch.bench import cost_bench as CB\n"
        "from repro_torch.core import arch as A\n"
        "archs = [A.get(n) for n in CB.ARCH_NAMES]\n"
        "name, trace = next(iter(CB._cases(True, 'cpu')))\n"
        "rows = [CB.bench_case(name, trace, archs, 'cpu'),\n"
        "        CB.bench_pipelined(device='cpu'),\n"
        "        CB.bench_warm_cache([A.get(n) for n in sorted(A.names())],\n"
        "                            device='cpu'),\n"
        "        CB.bench_construction(256, True, 'cpu')]\n"
        "print([r['total_cycles_16B'] for r in rows])\n"
        "assert all(r.get(k, True) is True for r in rows for k in (\n"
        "    'cycles_equal', 'pipelined_bit_equal', 'warm_bit_equal',\n"
        "    'construction_bit_equal'))\n"
        "CB.main.__globals__['rows'] = lambda smoke, device: rows\n"
        f"CB.main(['--device', 'cpu', '--out', r'{tmp_path / 'c.json'}'])\n")
    assert out.returncode == 0, out.stderr
    assert "isolated ok" in out.stdout
    assert "[1613, 5580, 71327, 135943]" in out.stdout
    assert (tmp_path / "c.json").exists()


def test_model_traffic_bench_and_quickstart_run_with_the_reference_blocked(
        tmp_path):
    """``python -m repro_torch.bench.model_traffic_bench --smoke --check
    --device cpu`` and ``python -m repro_torch.examples.quickstart
    --device cpu``, run as ``-m`` runs them, with JAX, ``repro`` and
    ``benchmarks`` blocked: the pinned flip holds and the quickstart's
    gather reads the rows."""
    out = _run_blocked(
        "import runpy\n"
        "sys.argv = ['model_traffic_bench', '--smoke', '--check',\n"
        f"            '--device', 'cpu', '--out', r'{tmp_path / 'm.json'}']\n"
        "runpy.run_module('repro_torch.bench.model_traffic_bench',\n"
        "                 run_name='__main__', alter_sys=True)\n"
        "sys.argv = ['quickstart', '--device', 'cpu']\n"
        "runpy.run_module('repro_torch.examples.quickstart',\n"
        "                 run_name='__main__', alter_sys=True)\n")
    assert out.returncode == 0, out.stderr
    assert "isolated ok" in out.stdout
    assert "model winners llama3.2-1b->16B; llama flips" in out.stdout
    assert "# check OK" in out.stdout
    assert "rows [1536.0, 30720.0, 3584.0, 3584.0]  (cost 54 cyc)" in \
        out.stdout
    assert (tmp_path / "m.json").exists()


def test_cpu_serving_runs_with_jax_and_repro_blocked():
    out = _run_blocked(
        "from repro_torch.launch import serve\n"
        "serve.main(['--smoke', '--device', 'cpu', '--cost', '--batch', '2',"
        " '--prompt-len', '12', '--new-tokens', '4'])\n")
    assert out.returncode == 0, out.stderr
    assert "isolated ok" in out.stdout
    assert "16B" in out.stdout and "4R-2W" in out.stdout


def test_cpu_hybrid_generate_runs_with_jax_and_repro_blocked():
    """A CPU jamba smoke ``ServeEngine.generate`` (Mamba, attention and MoE
    layers; paged and dense) and ``serve --arch jamba-v0.1-52b --smoke
    --cost`` with JAX, ``repro`` and ``benchmarks`` blocked: the two modes'
    tokens agree, and the one attention layer's traffic prices as the
    reference CLI's."""
    out = _run_blocked(
        "import numpy as np, torch\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.configs.base import RunConfig\n"
        "from repro_torch.models import init_tree, model_specs\n"
        "from repro_torch.launch.sharding import NO_AXES\n"
        "from repro_torch.serving.engine import ServeEngine\n"
        "cfg = get_smoke_config('jamba-v0.1-52b')\n"
        "params = init_tree(model_specs(cfg), torch.Generator()"
        ".manual_seed(0), device='cpu')\n"
        "prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,"
        " (2, 8))\n"
        "toks = [ServeEngine(cfg, RunConfig(remat='none', attn_impl='dense',"
        " compute_dtype='float32'), params, NO_AXES, max_batch=2, max_seq=16,"
        " kv_mode=m, device='cpu').generate(prompts, max_new_tokens=4)"
        ".tokens for m in ('paged', 'dense')]\n"
        "assert toks[0].shape == (2, 4) and (toks[0] == toks[1]).all()\n"
        "from repro_torch.launch import serve\n"
        "serve.main(['--arch', 'jamba-v0.1-52b', '--smoke', '--device',"
        " 'cpu', '--cost', '--batch', '2', '--prompt-len', '16',"
        " '--new-tokens', '4'])\n")
    assert out.returncode == 0, out.stderr
    assert "isolated ok" in out.stdout
    assert "(1 KV layers, page_len=8): step 4 ops, generation 14 ops" in \
        out.stdout
    assert "16B               144       494     0.64" in out.stdout


def test_cpu_scheduled_serving_runs_with_jax_and_repro_blocked():
    """``serve --schedule --smoke --device cpu --cost``: the reference's
    documented continuous-batching day (8 requests at 1.5 a tick, mixed
    contexts) with JAX, ``repro`` and ``benchmarks`` blocked; its traffic
    (which the weights do not change) on the reference's cycles."""
    out = _run_blocked(
        "from repro_torch.launch import serve\n"
        "serve.main(['--smoke', '--device', 'cpu', '--schedule',"
        " '--n-requests', '8', '--arrival-rate', '1.5', '--context-dist',"
        " 'mixed', '--cost'])\n")
    assert out.returncode == 0, out.stderr
    assert "isolated ok" in out.stdout
    lines = out.stdout.splitlines()
    assert sum(ln.startswith("req") for ln in lines) == 8
    assert "10 ticks, 8 decode steps" in out.stdout
    assert "scheduler KV traffic (2 KV layers): 128 ops" in out.stdout
    assert "16B               3356     4.35" in out.stdout


def test_cpu_faulted_day_runs_with_jax_and_repro_blocked():
    """A CPU chaos day on the smoke config (a bank lost at tick 3 with its
    live pages migrated, an ECC page recovered by re-prefill and replay, a
    decode step failing twice) finishes with the healthy day's tokens, and
    ``serve --schedule --fault-bank 1 --fault-tick 4 --cost`` prints its
    fault summary and the degraded row, with JAX, ``repro`` and
    ``benchmarks`` blocked."""
    out = _run_blocked(
        "import numpy as np, torch\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.configs.base import RunConfig\n"
        "from repro_torch.launch import serve\n"
        "from repro_torch.models import init_tree, model_specs\n"
        "from repro_torch.runtime import FaultEvent, FaultPlan\n"
        "from repro_torch.launch.sharding import NO_AXES\n"
        "from repro_torch.serving.engine import ServeEngine\n"
        "from repro_torch.serving.scheduler import Request\n"
        "cfg = get_smoke_config('llama3.2-1b')\n"
        "params = init_tree(model_specs(cfg),"
        " torch.Generator().manual_seed(0), device='cpu')\n"
        "eng = ServeEngine(cfg, RunConfig(remat='none', attn_impl='dense'),"
        " params, NO_AXES, max_batch=4, max_seq=32, mem_arch='16B-xor',"
        " device='cpu')\n"
        "rng = np.random.default_rng(0)\n"
        "spec = ((0, 12, 8), (0, 5, 6), (1, 8, 4), (2, 3, 0), (2, 9, 5),"
        " (3, 12, 3))\n"
        "reqs = [Request(i, a, p, m, rng.integers(0, cfg.vocab_size, p))"
        " for i, (a, p, m) in enumerate(spec)]\n"
        "plan = FaultPlan((FaultEvent(3, 'bank_offline', bank=1),"
        " FaultEvent(5, 'page_corrupt', rid=0),"
        " FaultEvent(6, 'decode_transient', failures=2)))\n"
        "healthy = eng.run_scheduler(reqs).outputs\n"
        "res = eng.run_scheduler(reqs, fault_plan=plan)\n"
        "assert all(np.array_equal(res.outputs[k], v)"
        " for k, v in healthy.items())\n"
        "f = res.stats['faults']\n"
        "assert f['migrated_pages'] > 0 and f['recoveries'] == 1, f\n"
        "assert f['transients'] == 2 and f['dead_banks'] == [1], f\n"
        "serve.main(['--smoke', '--device', 'cpu', '--schedule',"
        " '--fault-bank', '1', '--fault-tick', '4', '--cost'])\n")
    assert out.returncode == 0, out.stderr
    assert "isolated ok" in out.stdout
    assert "faults: bank(s) [1] lost at tick 4" in out.stdout
    assert "(degraded survivors)" in out.stdout


@pytest.mark.parametrize("chaos", [False, True])
def test_serving_bench_checks_run_with_the_reference_blocked(tmp_path,
                                                             chaos):
    """``python -m repro_torch.bench.serving_bench --smoke --check --device
    cpu`` and ``--chaos --smoke --check --device cpu``, run as ``-m`` runs
    them, with JAX, ``repro`` and ``benchmarks`` blocked: every gate holds
    and ``--out`` is written."""
    argv = ["serving_bench"] + (["--chaos"] if chaos else []) + [
        "--smoke", "--check", "--device", "cpu", "--out",
        str(tmp_path / "s.json")]
    out = _run_blocked(
        "import runpy\n"
        f"sys.argv = {argv!r}\n"
        "runpy.run_module('repro_torch.bench.serving_bench',\n"
        "                 run_name='__main__', alter_sys=True)\n")
    assert out.returncode == 0, out.stderr
    assert "isolated ok" in out.stdout
    assert ("# chaos check OK" if chaos else "# check OK") in out.stdout
    assert (tmp_path / "s.json").exists()


def test_cpu_preempted_day_resumes_with_jax_and_repro_blocked(tmp_path):
    """A CPU smoke day preempted at tick 4, checkpointed and resumed in a
    second call finishes with the uninterrupted day's tokens, with JAX,
    ``repro`` and ``benchmarks`` blocked."""
    out = _run_blocked(
        "import numpy as np, torch\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.configs.base import RunConfig\n"
        "from repro_torch.models import init_tree, model_specs\n"
        "from repro_torch.runtime import FaultEvent, FaultPlan\n"
        "from repro_torch.launch.sharding import NO_AXES\n"
        "from repro_torch.serving.engine import ServeEngine\n"
        "from repro_torch.serving.scheduler import Request\n"
        "cfg = get_smoke_config('llama3.2-1b')\n"
        "params = init_tree(model_specs(cfg),"
        " torch.Generator().manual_seed(0), device='cpu')\n"
        "eng = ServeEngine(cfg, RunConfig(remat='none', attn_impl='dense'),"
        " params, NO_AXES, max_batch=4, max_seq=32, device='cpu')\n"
        "rng = np.random.default_rng(0)\n"
        "spec = ((0, 12, 8), (0, 5, 6), (1, 8, 4), (2, 3, 0), (2, 9, 5),"
        " (3, 12, 3))\n"
        "reqs = [Request(i, a, p, m, rng.integers(0, cfg.vocab_size, p))"
        " for i, (a, p, m) in enumerate(spec)]\n"
        "plan = FaultPlan((FaultEvent(4, 'preempt'),))\n"
        "healthy = eng.run_scheduler(reqs).outputs\n"
        f"ck = r'{tmp_path / 'ck'}'\n"
        "first = eng.run_scheduler(reqs, fault_plan=plan,"
        " checkpoint_dir=ck)\n"
        "assert first.preempted and first.checkpoint, first\n"
        "res = eng.run_scheduler(None, fault_plan=plan, resume_from=ck)\n"
        "assert not res.preempted\n"
        "assert sorted(res.outputs) == sorted(healthy)\n"
        "assert all(np.array_equal(res.outputs[k], v)"
        " for k, v in healthy.items())\n"
        "print('resumed', first.ticks, res.ticks)\n")
    assert out.returncode == 0, out.stderr
    assert "isolated ok" in out.stdout
    assert "resumed 5 " in out.stdout


@pytest.mark.parametrize("module,argv,tail", [
    ("repro_torch.launch.train",
     ["--arch", "llama3.2-1b", "--smoke", "--steps", "3"], "final: {"),
    ("repro_torch.examples.train_lm", ["--steps", "40"], "loss ")])
def test_training_runs_with_the_reference_blocked(module, argv, tail):
    """``python -m repro_torch.launch.train --arch llama3.2-1b --smoke
    --steps 3 --device cpu`` and ``python -m
    repro_torch.examples.train_lm --steps 40 --device cpu`` (its loss must
    fall), run as ``-m`` runs them, with JAX, ``repro`` and ``benchmarks``
    blocked."""
    out = _run_blocked(
        "import runpy\n"
        "import torch\n"
        "torch.set_num_threads(1)  # see _torch_train_parity.one_torch_thread\n"
        f"sys.argv = {[module] + argv + ['--device', 'cpu']!r}\n"
        f"runpy.run_module({module!r}, run_name='__main__',"
        " alter_sys=True)\n")
    assert out.returncode == 0, out.stderr
    assert "isolated ok" in out.stdout
    assert any(ln.startswith(tail) for ln in out.stdout.splitlines())


def test_cpu_hybrid_train_step_runs_with_jax_and_repro_blocked():
    """One train step of the jamba smoke config (Mamba, attention and MoE
    layers: the backward through the scan and the dispatch) on the host,
    through the train CLI, with JAX, ``repro`` and ``benchmarks``
    blocked: its loss and grad_norm are finite and its aux above 0."""
    out = _run_blocked(
        "import math\n"
        "import torch\n"
        "torch.set_num_threads(1)  # see _torch_train_parity.one_torch_thread\n"
        "from repro_torch.launch import train\n"
        "final = train.main(['--arch', 'jamba-v0.1-52b', '--smoke',"
        " '--steps', '1', '--global-batch', '2', '--seq', '32',"
        " '--device', 'cpu'])['final']\n"
        "assert all(math.isfinite(final[k]) for k in ('loss',"
        " 'grad_norm')), final\n"
        "assert final['aux'] > 0 and final['grad_norm'] > 0, final\n")
    assert out.returncode == 0, out.stderr
    assert "isolated ok" in out.stdout


def test_analysis_cli_runs_with_the_reference_blocked():
    """``python -m repro_torch.analysis --device cpu``, run as ``-m`` runs
    it, from the repo root (the lint's default path is ``src``)."""
    script = (
        "import runpy\n"
        "import torch\n"
        "torch.set_num_threads(1)  # see _torch_train_parity.one_torch_thread\n"
        "sys.argv = ['analysis', '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.analysis', run_name='__main__',\n"
        "                     alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n")
    cwd = os.getcwd()
    os.chdir(SRC.parent)
    try:
        out = _run_blocked(script)
    finally:
        os.chdir(cwd)
    assert out.returncode == 0, out.stderr
    assert "isolated ok" in out.stdout
    lines = out.stdout.splitlines()
    assert lines[0] == "lint: 0 finding(s) over src"
    assert "prove: facts hold — 16B-xor transpose loads conflict-free; " \
        "16B lsb column stores 16-way serialized" in lines
    assert "check: ServeEngine recorded serving_stream: ok (4 blocks, " \
        "28 ops, 28 instructions)" in lines
    assert "analysis: OK" in lines


def test_online_tuner_over_a_generation_runs_with_the_reference_blocked():
    out = _run_blocked(
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)  # see _torch_train_parity.one_torch_thread\n"
        "from repro_torch import tune\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.configs.base import RunConfig\n"
        "from repro_torch.models import init_tree, model_specs\n"
        "from repro_torch.launch.sharding import NO_AXES\n"
        "from repro_torch.serving.engine import ServeEngine\n"
        "cfg = get_smoke_config('llama3.2-1b')\n"
        "params = init_tree(model_specs(cfg), torch.Generator()"
        ".manual_seed(0), device='cpu')\n"
        "eng = ServeEngine(cfg, RunConfig(remat='none', attn_impl='dense'),"
        " params, NO_AXES, max_batch=2, max_seq=24, device='cpu')\n"
        "eng.generate(np.random.default_rng(0).integers(0, cfg.vocab_size,"
        " (2, 10)), max_new_tokens=6)\n"
        "tuner = tune.online(eng, window=3, device='cpu')\n"
        "recs = [tuner.step(eng.step_trace(i)) for i in range(5)]\n"
        "assert [r['window_blocks'] for r in recs] == [1, 2, 3, 3, 3]\n"
        "assert tuner.cache.stats['hits'] > 0\n"
        "assert tuner.reprice(full_rebuild=True) == tuner.reprice()\n"
        "print('winner', recs[-1]['winner'])\n")
    assert out.returncode == 0, out.stderr
    assert "isolated ok" in out.stdout and "winner " in out.stdout


def test_new_entry_points_default_to_the_card():
    import inspect

    from repro_torch.analysis.symbolic import cross_check
    from repro_torch.models.trace import model_step_symbolic
    from repro_torch.serving.kvcache import init_state
    from repro_torch.tune.online import OnlineTuner
    for fn in (cross_check, OnlineTuner.__init__, init_state,
               model_step_symbolic):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    import pytest
    import torch

    from repro_torch.analysis.__main__ import main
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            main(["--prove"])
        assert e.value.code == 2


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
