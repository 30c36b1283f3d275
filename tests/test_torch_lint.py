"""The port's repro-lint rules (``repro_torch/analysis/lint.py``): each of
``tests/test_lint.py``'s rule cases restated with PyTorch snippets, each
rule firing on its fixture exactly once."""
import pytest

pytest.importorskip("torch")

from repro_torch.analysis import lint

SRC = "src/repro_torch/x.py"


def only(findings, rule):
    assert [f.rule for f in findings] == [rule], findings
    return findings[0]


# ---------------------------------------------------------------- R1

def test_r1_cuda_graph_outside_graph_cache():
    src = ("import torch\n"
           "\n"
           "def capture(fn, x):\n"
           "    g = torch.cuda.CUDAGraph()\n"
           "    with torch.cuda.graph(g):\n"
           "        y = fn(x)\n"
           "    return g, y\n")
    fs = lint.scan_sources({SRC: src})
    assert [f.rule for f in fs] == ["R1", "R1"]
    assert fs[0].line == 4 and "GraphCache" in fs[0].message
    assert fs[0].key == "g = torch.cuda.CUDAGraph()"


def test_r1_graph_cache_in_loop():
    src = ("from repro_torch.core.compile_cache import GraphCache\n"
           "\n"
           "def run(fs, x):\n"
           "    for f in fs:\n"
           "        x = GraphCache().call('f', f, (x,))\n"
           "    return x\n")
    f = only(lint.scan_sources({SRC: src}), "R1")
    assert "loop" in f.message


def test_r1_python_scalar_into_graph_cache_call():
    src = ("from repro_torch.core.compile_cache import GraphCache\n"
           "\n"
           "class Engine:\n"
           "    def __init__(self):\n"
           "        self._graphs = GraphCache()\n"
           "\n"
           "    def run(self, fn, x):\n"
           "        return self._graphs.call('run', fn, (x, x.shape[0]))\n")
    f = only(lint.scan_sources({SRC: src}), "R1")
    assert "baked into the graph" in f.message and f.line == 8


def test_r1_respects_import_alias():
    src = ("from torch import compile as C\n"
           "\n"
           "def fast(f):\n"
           "    return C(f)\n")
    only(lint.scan_sources({SRC: src}), "R1")


def test_r1_ignores_graph_cache_module():
    src = ("import torch\n"
           "g = torch.cuda.CUDAGraph()\n")
    assert lint.scan_sources(
        {"src/repro_torch/core/compile_cache.py": src}) == []


# ---------------------------------------------------------------- R2

_CAPTURED = ("from repro_torch.core.compile_cache import GraphCache\n"
             "\n"
             "_GRAPHS = GraphCache()\n"
             "\n")


def test_r2_host_sync_reachable_from_a_captured_body():
    src = _CAPTURED + ("def body(c, x):\n"
                       "    return c, float(x)\n"
                       "\n"
                       "def run(c, x):\n"
                       "    return _GRAPHS.call('b', body, (c, x))\n")
    f = only(lint.scan_sources({SRC: src}), "R2")
    assert "float()" in f.message and f.line == 6


def test_r2_tolist_reachable_through_call_graph():
    # helper is only captured transitively: body -> helper
    src = _CAPTURED + ("def helper(x):\n"
                       "    return x.tolist()\n"
                       "\n"
                       "def body(c, x):\n"
                       "    return c, helper(x)\n"
                       "\n"
                       "def run(c, x):\n"
                       "    return _GRAPHS.call('b', body, (c, x))\n")
    f = only(lint.scan_sources({SRC: src}), "R2")
    assert ".tolist()" in f.message and f.line == 6


def test_r2_if_on_captured_param():
    src = _CAPTURED + ("def body(c, x):\n"
                       "    if x:\n"
                       "        return c, x\n"
                       "    return c, x\n"
                       "\n"
                       "def run(c, x):\n"
                       "    return _GRAPHS.call('b', body, (c, x))\n")
    f = only(lint.scan_sources({SRC: src}), "R2")
    assert "`if` on captured value" in f.message


def test_r2_exemptions():
    # shape-derived ints are host values; `if` on attribute access is
    # static config branching; `is None` tests no tensor; all stay silent
    src = _CAPTURED + ("def body(c, x, m):\n"
                       "    n = int(x.shape[0])\n"
                       "    if c.flag or m is None:\n"
                       "        return c, x * n\n"
                       "    return c, x\n"
                       "\n"
                       "def run(c, x):\n"
                       "    return _GRAPHS.call('b', body, (c, x, None))\n")
    assert lint.scan_sources({SRC: src}) == []


def test_r2_uncaptured_function_is_silent():
    src = ("import torch\n"
           "\n"
           "def report(x):\n"
           "    torch.cuda.synchronize()\n"
           "    return float(x), x.item(), x.cpu()\n")
    assert lint.scan_sources({SRC: src}) == []


# ---------------------------------------------------------------- R3

def test_r3_read_after_mesh_step_donation():
    src = ("from repro_torch.launch.steps import jit_train_step\n"
           "\n"
           "def step(cfg, fed, mesh, shape, params, state, anchor, batch):\n"
           "    fn, _ = jit_train_step(cfg, fed, mesh, shape, params, batch)\n"
           "    new, state, loss = fn(params, state, anchor, batch)\n"
           "    return new, params['w'].sum()\n")
    f = only(lint.scan_sources({SRC: src}), "R3")
    assert "'params'" in f.message and f.line == 6


def test_r3_rebind_and_donate_false_clear_donation():
    src = ("from repro_torch.launch.steps import jit_serve_step\n"
           "\n"
           "def serve(cfg, mesh, shape, params, tok, cache, pos):\n"
           "    fn, _ = jit_serve_step(cfg, mesh, shape, params, cache)\n"
           "    tok, cache = fn(params, tok, cache, pos)\n"
           "    keep, _ = jit_serve_step(cfg, mesh, shape, params, cache,\n"
           "                             donate=False)\n"
           "    tok2, out = keep(params, tok, cache, pos)\n"
           "    return tok, cache, out\n")
    assert lint.scan_sources({SRC: src}) == []


def test_r3_engine_donate_keyword():
    src = ("def go(engine, params, stack):\n"
           "    out = engine(params, stack, donate=True)\n"
           "    return out, stack\n")
    f = only(lint.scan_sources({SRC: src}), "R3")
    assert "'stack'" in f.message


# ---------------------------------------------------------------- R4

def test_r4_orphan_kernel():
    files = {
        "src/repro_torch/kernels/deadop.py": ("def dead_kernel(x):\n"
                                              "    return x\n"),
        "src/repro_torch/core/user.py": "def use():\n    return 1\n",
    }
    f = only(lint.scan_sources(files), "R4")
    assert "deadop.dead_kernel" in f.message
    assert f.key == "deadop.dead_kernel"


def test_r4_referenced_kernel_is_alive():
    files = {
        "src/repro_torch/kernels/op.py": "def my_kernel(x):\n    return x\n",
        "src/repro_torch/core/user.py": (
            "from repro_torch.kernels.op import my_kernel\n"
            "def use(x):\n"
            "    return my_kernel(x)\n"),
    }
    assert lint.scan_sources(files) == []


# ---------------------------------------------------------------- R5

def test_r5_bare_assert():
    src = ("def f(x):\n"
           "    assert x > 0, 'positive'\n"
           "    return x\n")
    f = only(lint.scan_sources({SRC: src}), "R5")
    assert "python -O" in f.message and f.line == 2
