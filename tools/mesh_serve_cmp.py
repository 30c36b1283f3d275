"""One checkout's four-card mesh train and serve cases, for comparing two
trees.

Loads a checkout's ``tests/test_torch_cuda_lm_mesh.py`` and runs its
``_train`` and ``_serve`` on the (2, 2) ``("data", "model")`` mesh:
Hymba-1.5B's train step (its last, profiled step also counting the
collectives it dispatches) and its serve step (the last token counting
its collectives). Where the checkout's steps run as CUDA graphs, those
steps and tokens are replays, which dispatch nothing: the counts are
then the eager body's last step and token (``fn.eager``), and the
report has what the replays ran on the card (``last_step_on_card``,
``last_token_on_card``). Rank 0 writes every rank's report to OUT as
JSON.
Run under ``torchrun`` on four cards with that checkout's ``src`` first
on ``PYTHONPATH``; ``tools/mesh_serve_cmp.sh`` runs two checkouts in
turns.
"""
import importlib.util
import json
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class _Collectives(TorchDispatchMode):
    """The collectives dispatched inside, counted by kind."""

    def __init__(self):
        super().__init__()
        self.count = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from repro_torch.roofline.counter import COLLECTIVES
        kind = COLLECTIVES.get(func.overloadpacket.__name__)
        if kind is not None and func.namespace in ("_c10d_functional",
                                                   "c10d_functional",
                                                   "c10d"):
            self.count[kind] = self.count.get(kind, 0) + 1
        return func(*args, **(kwargs or {}))


class _CountedProfile:
    """A profiler that also counts the collectives dispatched inside it
    into ``box``."""

    def __init__(self, prof, box: list):
        self.prof, self.box, self.mode = prof, box, _Collectives()

    def __enter__(self):
        self.prof.__enter__()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        self.box.append(self.mode.count)
        return self.prof.__exit__(*exc)

    def key_averages(self):
        return self.prof.key_averages()


def _counting(call, n: int, box: list):
    """``call`` counting the collectives of its ``n``-th call into
    ``box``."""
    calls = [0]

    def counted(*a, **k):
        calls[0] += 1
        if calls[0] != n:
            return call(*a, **k)
        with _Collectives() as c:
            out = call(*a, **k)
        box.append(c.count)
        return out
    vars(counted).update(vars(call))
    return counted


def _count_call(make, n: int, box: list):
    """``jit_serve_step`` whose eager body (``fn.eager``; ``fn`` where it
    has none) counts the collectives of its ``n``-th call into
    ``box``."""
    def wrapped(*a, **k):
        fn, specs = make(*a, **k)
        if hasattr(fn, "eager"):
            fn.eager = _counting(fn.eager, n, box)
            return fn, specs
        return _counting(fn, n, box), specs
    return wrapped


def main(test_file: str, out: str) -> int:
    spec = importlib.util.spec_from_file_location("cards", test_file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import destroy_world, init_world, make_mesh
    init_world()
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((2, 2), ("data", "model"))
    cfg = get_config("hymba-1.5b")
    train_box, serve_box = [], []
    profiler = mod._profiler
    mod._profiler = lambda: _CountedProfile(profiler(), train_box)
    res = {"hymba_train": mod._train(mesh, cfg)}
    mod._profiler = profiler
    res["hymba_train"]["last_step_collectives"] = train_box[-1]
    mod._free()
    make = steps.jit_serve_step
    steps.jit_serve_step = _count_call(make, mod.SERVE[3], serve_box)
    res["hymba"] = mod._serve(mesh, cfg)
    steps.jit_serve_step = make
    res["hymba"]["last_token_collectives"] = serve_box[0]
    per = [None] * dist.get_world_size()
    dist.all_gather_object(per, res)
    if dist.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(per, f)
    destroy_world()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
