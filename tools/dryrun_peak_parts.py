"""What rank 0 holds at its peak in one dry-run combo, by part.

Runs one (arch, shape) of ``repro_torch.launch.dryrun`` on its fake
production mesh under a ``roofline.counter.Counter`` that also labels
every storage it tracks (the op that made it, its shape and dtype; the
step's inputs as ``input``) and keeps the live storages at the peak.
Prints the peak and its largest parts, grouped by label, as JSON:

    PYTHONPATH=src python tools/dryrun_peak_parts.py --arch \\
        llama4-scout-17b-a16e --shape train_4k --mesh pod
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.configs import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.roofline.counter import Counter
from repro_torch.types import FedConfig


class PeakParts(Counter):
    """A ``Counter`` that labels each storage and snapshots the live ones
    whenever the peak rises."""

    def __init__(self, watch=()):
        self.labels: dict = {}
        self.at_peak: dict = {}
        self._op = "input"
        super().__init__(watch=watch)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._op = func.overloadpacket.__name__
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _track(self, t) -> None:
        before = self.peak
        try:
            key = t.untyped_storage()._cdata
        except (RuntimeError, NotImplementedError):
            return
        if key not in self._storages:
            self.labels[key] = (self._op, tuple(t.shape), str(t.dtype))
        super()._track(t)
        if self.peak > before:       # a key is reused once its storage dies
            self.at_peak = {k: (n, self.labels[k])
                            for k, n in self._storages.items()}


def peak_parts(arch: str, shape: str, mesh_name: str, top: int) -> dict:
    dryrun.fake_world(dryrun.MESH_WORLD[mesh_name])
    try:
        mesh = mesh_mod.make_production_mesh(
            multi_pod=mesh_name == "multipod", device="cpu")
        cfg = dryrun.get_arch(arch)
        sc = SHAPES[shape]
        with dryrun._fake_mode():
            if sc.kind == "train":
                fn, args = dryrun._train_program(
                    cfg, sc, mesh, FedConfig(), dryrun.PARAM_DTYPE, True, {})
            elif sc.kind == "prefill":
                fn, args = dryrun._prefill_program(
                    cfg, sc, mesh, dryrun.PARAM_DTYPE, True, {})
            else:
                fn, args = dryrun._serve_program(cfg, sc, mesh, {})
            with PeakParts(watch=args) as c:
                fn(*args)
    finally:
        mesh_mod.destroy_world()
    groups: dict = {}
    for n, (op, shp, dt) in c.at_peak.values():
        label = f"{op} {list(shp)} {dt}"
        g = groups.setdefault(label, [0, 0])
        g[0] += n
        g[1] += 1
    parts = sorted(groups.items(), key=lambda kv: -kv[1][0])
    return {"arch": arch, "shape": shape, "mesh": mesh_name,
            "peak_gb": c.peak / 1e9,
            "parts": [{"label": k, "gb": v[0] / 1e9, "storages": v[1]}
                      for k, v in parts[:top]],
            "rest_gb": sum(v[0] for _, v in parts[top:]) / 1e9}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", choices=["pod", "multipod"], default="pod")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    print(json.dumps(peak_parts(args.arch, args.shape, args.mesh, args.top),
                     indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
