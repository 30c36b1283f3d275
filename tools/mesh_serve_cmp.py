"""One checkout's four-card mesh serve case, for comparing two trees.

Loads a checkout's ``tests/test_torch_cuda_lm_mesh.py`` and runs its
``_serve`` on the (2, 2) ``("data", "model")`` mesh: Hymba-1.5B, and with
``new`` also h2o-danube-3-4b beside its all-gathered layout (a test file
whose ``_serve`` takes ``gathered``). Rank 0 writes every rank's report
to OUT as JSON. Run under ``torchrun`` on four cards with that
checkout's ``src`` first on ``PYTHONPATH``; ``tools/mesh_serve_cmp.sh``
runs two checkouts in turns.
"""
import importlib.util
import json
import sys

import torch


def main(test_file: str, out: str, which: str) -> int:
    spec = importlib.util.spec_from_file_location("cards", test_file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import destroy_world, init_world, make_mesh
    init_world()
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((2, 2), ("data", "model"))
    res = {"hymba": mod._serve(mesh, get_config("hymba-1.5b"))}
    mod._free()
    if which == "new":
        res["h2o"] = mod._serve(mesh, get_config("h2o-danube-3-4b"),
                                gathered=True)
    per = [None] * dist.get_world_size()
    dist.all_gather_object(per, res)
    if dist.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(per, f)
    destroy_world()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:4]))
