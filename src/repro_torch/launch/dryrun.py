"""Multi-pod dry run: count every (architecture × input shape) on the
production meshes without hardware, and write the roofline JSON rows
(port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each combination for 256 or 512 host
placeholder devices and reads the compiled program. PyTorch compiles
nothing, so this counts rank 0's step instead: a fake world of 256 or 512
ranks (``fake_world``: the ``fake`` backend of ``torch.testing``, whose
collectives move nothing), the port's own meshes over it
(``launch/mesh.py::make_production_mesh``), and every tensor a
``FakeTensorMode`` tensor (shapes and dtypes, no storage, no compute).
``roofline/counter.py`` counts the flops, bytes and collectives of the
step and the peak bytes rank 0 holds. Like the reference's, it takes the
eager attention path: the kernel wrappers refuse tensors that are not on
the CPU or the card. This is the one entry point that runs no device
work by design.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                # everything
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-12b \\
        --shape train_4k --mesh pod                                   # one combo
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list         # the matrix

An arch named ``<arch>-reduced`` is that config's ``reduced()`` variant.
Rows go to ``experiments/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, get_config,
                                 shape_supported)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import registry
from repro_torch.roofline.counter import Counter
from repro_torch.sharding import specs as shspecs
from repro_torch.types import FedConfig

PARAM_DTYPE = torch.float32    # master weights (SGD momentum rides f32)
ACT_DTYPE = torch.bfloat16
OUT_DIR = "experiments/dryrun_torch"
MESH_WORLD = {"pod": 256, "multipod": 512}


def get_arch(arch: str):
    """The config of ``arch``; ``<arch>-reduced`` is its ``reduced()``."""
    if arch.endswith("-reduced"):
        return get_config(arch[:-len("-reduced")]).reduced()
    return get_config(arch)


def fake_world(world_size: int) -> None:
    """Make the default process group a fake world of ``world_size``
    ranks, this process rank 0. A fake world of another size is replaced
    (its meshes and engines dropped); a real process group is refused."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group exists: the dry "
                "run makes a fake world of its own and never runs on a "
                "real one")
        if dist.get_world_size() == world_size:
            return
        mesh_mod.destroy_world()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def params_struct(cfg, dtype=PARAM_DTYPE) -> dict:
    """The params of ``cfg`` as fake tensors (call it under a
    ``FakeTensorMode``): the counterpart of ``jax.eval_shape`` of
    ``init_params``."""
    return registry.init_params(torch.Generator().manual_seed(0), cfg,
                                "cpu", dtype)


def _fake(spec) -> dict:
    """Fake tensors of a tree of meta specs (``batch_spec``,
    ``decode_spec``), under the active ``FakeTensorMode``."""
    if isinstance(spec, dict):
        return {k: _fake(v) for k, v in spec.items()}
    return torch.zeros(spec.shape, dtype=spec.dtype)


def model_flops(cfg, shape) -> float:
    """6·N_active·D (train) or 2·N_active·D (forward-only decode/prefill)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n * toks
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # one token per sequence


def _check_opts(cfg, opts: dict) -> None:
    """The reference's options the port has no counterpart for raise."""
    if not opts.get("moe_shardmap", True) and cfg.moe is not None:
        raise ValueError(
            "--no-moe-shardmap: the port has no pjit-only MoE dispatch; "
            "on a mesh its MoE routes through moe_ctx's distributed "
            "dispatch (models/moe.py), the reference's shard_map path")


def lower_combo(arch: str, shape_name: str, mesh, mesh_name: str,
                fed: FedConfig, constrain_acts: bool = True,
                opts: dict | None = None, cfg=None):
    """Count rank 0's step of (``arch``, ``shape_name``) on ``mesh`` (its
    world a ``fake_world``) and return its ``RooflineReport``. ``cfg``
    replaces ``arch``'s config (a cut of it, say), the row keeping the
    name.

    opts (all default off — the paper-faithful/naive BASELINE):
      param_dtype: 'f32'|'bf16'  — bf16 master weights (train/prefill)
      prefill_act: bool          — residual seq-sharding during prefill
                                   (True in the baseline)
      serve_unroll: bool         — python-unroll decode layers
      window_slice: bool         — SWA layers read only their window of
                                   the cache (requires serve_unroll)
      moe_fullgrid_dispatch: bool — MoE dispatch over (data×model)
                                   instead of data
      ring_cache: bool           — decode against the ring cache
      q_chunk / loss_chunk: int  — the train loss's chunks
    """
    opts = dict(opts or {})
    cfg = cfg or get_arch(arch)
    _check_opts(cfg, opts)
    shape = SHAPES[shape_name]
    pdtype = torch.bfloat16 if opts.get("param_dtype") == "bf16" \
        else PARAM_DTYPE
    with _fake_mode():
        if shape.kind == "train":
            fn, args = _train_program(cfg, shape, mesh, fed, pdtype,
                                      constrain_acts, opts)
        elif shape.kind == "prefill":
            fn, args = _prefill_program(cfg, shape, mesh, pdtype,
                                        constrain_acts, opts)
        else:
            fn, args = _serve_program(cfg, shape, mesh, opts)
        with Counter(watch=args) as c:
            fn(*args)
    return c.report(arch=arch, shape=shape_name, mesh_name=mesh_name,
                    chips=mesh.size(),
                    model_flops_global=model_flops(cfg, shape),
                    model_precision="bf16")


def _train_program(cfg, shape, mesh, fed, pdtype, constrain_acts, opts):
    """``jit_train_step``'s eager body (a counter counts no graph) and its
    placed arguments (params, momentum, anchor, batch)."""
    pstruct = params_struct(cfg, pdtype)
    bstruct = registry.batch_spec(cfg, shape, ACT_DTYPE)
    tkw = {k: int(opts[k]) for k in ("q_chunk", "loss_chunk")
           if opts.get(k)}
    fn, (in_specs, _) = steps_mod.jit_train_step(
        cfg, fed, mesh, shape, pstruct, bstruct,
        constrain_acts=constrain_acts, donate=True,
        moe_fullgrid=opts.get("moe_fullgrid_dispatch", False),
        train_kwargs=tkw)
    pspec, _, _, bspec = in_specs
    state = fn.opt.init(pstruct)
    if state["mom"] is not None:
        state["mom"] = shspecs.place(mesh, state["mom"], pspec)
    params = shspecs.place(mesh, pstruct, pspec)
    anchor = shspecs.place(mesh, {k: v.clone() for k, v in pstruct.items()},
                           pspec)
    batch = shspecs.place(mesh, _fake(bstruct), bspec)
    return fn.eager, (params, state, anchor, batch)


def _prefill_program(cfg, shape, mesh, pdtype, constrain_acts, opts):
    """The forward-only half of the train step: the rank's rows scored
    (``registry.loss_fn``) on the rank's placed blocks, laid out as the
    train step lays them out (``sharding.MeshSplit`` by
    ``compute_layout``, the residual split over ``"model"`` on its
    sequence under ``act_pspec``)."""
    pstruct = params_struct(cfg, pdtype)
    bstruct = registry.batch_spec(cfg, shape, ACT_DTYPE)
    pspec = shspecs.param_pspecs(mesh, cfg, pstruct)
    bspec = shspecs.batch_pspecs(mesh, cfg, bstruct)
    use_act = opts.get("prefill_act", True) and constrain_acts
    split, moe_ctx = steps_mod.mesh_split(
        cfg, mesh, shape.seq_len, pstruct,
        rows=steps_mod._spec_axes(next(iter(bspec.values()))[0]),
        seq=use_act, moe_fullgrid=bool(opts.get("moe_fullgrid_dispatch")))
    kw = {"split": split}
    if moe_ctx is not None:
        kw["moe_ctx"] = moe_ctx

    @torch.no_grad()
    def fwd(params, batch):
        local = {k: v.to_local() for k, v in params.items()}
        rows = {k: v.to_local() for k, v in batch.items()}
        return registry.loss_fn(local, cfg, rows, remat=False,
                                dtype=ACT_DTYPE, **kw)[0]

    return fwd, (shspecs.place(mesh, pstruct, pspec),
                 shspecs.place(mesh, _fake(bstruct), bspec))


def _serve_program(cfg, shape, mesh, opts):
    """``jit_serve_step``'s eager body (bf16 weights and cache) and its
    placed arguments (params, token, cache, pos)."""
    pstruct = params_struct(cfg, ACT_DTYPE)      # serving: bf16 weights
    ring = opts.get("ring_cache", False) and \
        cfg.family in ("dense", "moe", "hybrid", "vlm", "ssm") and \
        cfg.sliding_window > 0
    tok, cspec, pos = registry.decode_spec(cfg, shape, ACT_DTYPE)
    if ring:
        cspec = registry.init_ring_cache(cfg, shape.global_batch,
                                         shape.seq_len, ACT_DTYPE,
                                         device="meta")
    fn, (in_specs, _) = steps_mod.jit_serve_step(
        cfg, mesh, shape, pstruct, cspec, donate=True,
        unroll=opts.get("serve_unroll", False),
        window_slice=opts.get("window_slice", False), ring=ring)
    pspec, tspec, cache_spec, _ = in_specs
    return fn.eager, (shspecs.place(mesh, pstruct, pspec),
                shspecs.place(mesh, _fake(tok), tspec),
                shspecs.place(mesh, _fake(cspec), cache_spec),
                _fake(pos))


def _strip_pod(entry):
    """A spec entry without ``"pod"``: per-pod client models cannot also
    split over it."""
    if entry == "pod":
        return None
    if isinstance(entry, tuple):
        rest = tuple(a for a in entry if a != "pod")
        return rest[0] if len(rest) == 1 else (rest or None)
    return entry


def lower_fl_aggregation(arch: str, mesh, mesh_name: str, fed: FedConfig,
                         beta_t: float = 0.7) -> dict:
    """Count the paper's server-side programs on the production mesh:

    1. the async mixing update w_t = (1-β_t)·w_{t-1} + β_t·w_new
       (Algorithm 1 server line) over FSDP×tensor-split parameters
       (``steps.mixing_step`` on the ranks' blocks);
    2. synchronous FedAvg across the pod axis: each pod's client model
       laid out without ``"pod"``, summed over it (an all-reduce) and
       scaled by 1/npod (the straggler-barrier collective the paper's
       async design removes).
    """
    cfg = get_arch(arch)
    chips = mesh.size()
    results = {}
    with _fake_mode():
        pstruct = params_struct(cfg)
        pspec = shspecs.param_pspecs(mesh, cfg, pstruct)
        prev = shspecs.place(mesh, pstruct, pspec)
        new = shspecs.place(mesh, {k: v.clone() for k, v in pstruct.items()},
                            pspec)
        local = lambda t: {k: v.to_local() for k, v in t.items()}
        mix = steps_mod.mixing_step(beta_t)
        with Counter(watch=(prev, new)) as c:
            mix(local(prev), local(new))
        results["mixing"] = c.report(
            arch=arch, shape="mixing_update", mesh_name=mesh_name,
            chips=chips, model_flops_global=2.0 * cfg.param_count())
        if "pod" in mesh.mesh_dim_names:
            npod = mesh.size(mesh.mesh_dim_names.index("pod"))
            sspec = {k: shspecs.P(*(_strip_pod(e) for e in tuple(sp)))
                     for k, sp in pspec.items()}
            client = local(shspecs.place(mesh, pstruct, sspec))

            @torch.no_grad()
            def fedavg(w):
                return {k: (shspecs.psum_axes(v.float(), mesh, "pod")
                            * (1.0 / npod)).to(v.dtype)
                        for k, v in w.items()}

            with Counter(watch=(client,)) as c:
                fedavg(client)
            results["fedavg"] = c.report(
                arch=arch, shape="fedavg_pod", mesh_name=mesh_name,
                chips=chips, model_flops_global=npod * cfg.param_count())
    return results


def _ms(s: float) -> str:
    return f"{s * 1e3:.2f}ms"


def run_matrix(archs, shapes, meshes, constrain_acts=True, tag="baseline",
               out_dir=OUT_DIR, fed: FedConfig | None = None,
               verbose=True, opts: dict | None = None):
    """Every (arch, shape) on each of ``meshes`` ("pod", "multipod"), a
    JSON row a combination under ``out_dir`` and a summary; the fake
    world is destroyed at the end. Returns (rows, failures)."""
    fed = fed or FedConfig()
    os.makedirs(out_dir, exist_ok=True)
    rows, failures = [], []
    try:
        for mesh_name in meshes:
            fake_world(MESH_WORLD[mesh_name])
            mesh = make_production_mesh(multi_pod=(mesh_name == "multipod"),
                                        device="cpu")
            for arch in archs:
                cfg = get_arch(arch)
                for shape_name in shapes:
                    ok, why = shape_supported(cfg, SHAPES[shape_name])
                    key = f"{arch}|{shape_name}|{mesh_name}"
                    if not ok:
                        rows.append({"arch": arch, "shape": shape_name,
                                     "mesh": mesh_name, "status": "SKIP",
                                     "reason": why})
                        if verbose:
                            print(f"[skip] {key}: {why}", flush=True)
                        continue
                    t0 = time.time()
                    try:
                        rep = lower_combo(arch, shape_name, mesh, mesh_name,
                                          fed, constrain_acts=constrain_acts,
                                          opts=opts)
                    except Exception as e:  # noqa: BLE001 - the matrix goes on
                        failures.append((key, repr(e)))
                        rows.append({"arch": arch, "shape": shape_name,
                                     "mesh": mesh_name, "status": "FAIL",
                                     "error": repr(e)})
                        if verbose:
                            print(f"[FAIL] {key}: {e}", flush=True)
                            traceback.print_exc()
                        continue
                    row = rep.to_dict()
                    row["status"] = "OK"
                    row["count_s"] = time.time() - t0
                    rows.append(row)
                    fname = os.path.join(
                        out_dir, f"{tag}_{arch}_{shape_name}_{mesh_name}.json")
                    with open(fname, "w") as f:
                        json.dump(row, f, indent=1)
                    if verbose:
                        print(f"[ok]   {key}: compute={_ms(rep.compute_s)} "
                              f"memory={_ms(rep.memory_s)} "
                              f"collective={_ms(rep.collective_s)} "
                              f"dominant={rep.dominant} "
                              f"peakmem={rep.peak_memory_bytes/2**30:.2f}GiB "
                              f"(counted in {row['count_s']:.1f}s)",
                              flush=True)
    finally:
        mesh_mod.destroy_world()
    summary = os.path.join(out_dir, f"{tag}_summary.json")
    with open(summary, "w") as f:
        json.dump(rows, f, indent=1)
    return rows, failures


def _fl_aggregation(archs, meshes, out_dir: str, tag: str) -> int:
    os.makedirs(out_dir, exist_ok=True)
    try:
        for mesh_name in meshes:
            fake_world(MESH_WORLD[mesh_name])
            mesh = make_production_mesh(multi_pod=(mesh_name == "multipod"),
                                        device="cpu")
            for arch in archs:
                res = lower_fl_aggregation(arch, mesh, mesh_name,
                                           FedConfig())
                for kind, rep in res.items():
                    fn = os.path.join(out_dir, f"{tag}_fl_{kind}_{arch}_"
                                               f"{mesh_name}.json")
                    with open(fn, "w") as f:
                        json.dump(rep.to_dict(), f, indent=1)
                    print(f"[ok] fl_{kind} {arch}|{mesh_name}: "
                          f"memory={_ms(rep.memory_s)} "
                          f"collective={_ms(rep.collective_s)} "
                          f"peak={rep.peak_memory_bytes/2**30:.2f}GiB",
                          flush=True)
    finally:
        mesh_mod.destroy_world()
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--no-act-sharding", action="store_true",
                    help="disable the residual-stream sharding constraint "
                         "(the unoptimized baseline)")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--param-dtype", choices=["f32", "bf16"], default="f32")
    ap.add_argument("--no-prefill-act", action="store_true")
    ap.add_argument("--serve-unroll", action="store_true")
    ap.add_argument("--window-slice", action="store_true")
    ap.add_argument("--moe-fullgrid", action="store_true")
    ap.add_argument("--ring-cache", action="store_true")
    ap.add_argument("--no-moe-shardmap", action="store_true",
                    help="naive pjit-only MoE dispatch (the reference's "
                         "pre-fix path; the port has none and raises)")
    ap.add_argument("--q-chunk", type=int, default=0)
    ap.add_argument("--loss-chunk", type=int, default=0)
    ap.add_argument("--fl-aggregation", action="store_true",
                    help="count the FL server programs (mixing + cross-pod "
                         "FedAvg) instead of the train/serve matrix")
    args = ap.parse_args(argv)

    archs = args.arch or list(ASSIGNED_ARCHS)
    shapes = args.shape or list(SHAPES)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    if args.fl_aggregation:
        return _fl_aggregation(archs, meshes, args.out, args.tag)

    if args.list:
        for a in archs:
            cfg = get_arch(a)
            for s in shapes:
                ok, why = shape_supported(cfg, SHAPES[s])
                print(f"{a:28s} {s:12s} {'RUN' if ok else 'SKIP  ' + why}")
        return 0

    opts = {"param_dtype": args.param_dtype,
            "prefill_act": not args.no_prefill_act,
            "serve_unroll": args.serve_unroll,
            "window_slice": args.window_slice,
            "moe_fullgrid_dispatch": args.moe_fullgrid,
            "ring_cache": args.ring_cache,
            "moe_shardmap": not args.no_moe_shardmap,
            "q_chunk": args.q_chunk, "loss_chunk": args.loss_chunk}
    rows, failures = run_matrix(archs, shapes, meshes,
                                constrain_acts=not args.no_act_sharding,
                                tag=args.tag, out_dir=args.out, opts=opts)
    ok = sum(1 for r in rows if r.get("status") == "OK")
    sk = sum(1 for r in rows if r.get("status") == "SKIP")
    print(f"\n== dry-run: {ok} OK, {sk} skipped, {len(failures)} failed ==")
    for k, e in failures:
        print(f"  FAIL {k}: {e}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
