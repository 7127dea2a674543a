"""The dry run (the port of ``repro/launch/dryrun.py``): every (arch x shape
x mesh) cell's step, run once on ``meta`` tensors on a fake process group
of the production mesh's size, with no card and no data.

Each cell runs on a fake group of 256 ranks (the single-pod (16, 16)
``("data", "model")`` mesh) or 512 (the (2, 16, 16) ``("pod", "data",
"model")`` mesh), from ``launch/mesh.py``'s ``make_production_mesh``.  The
family's ``dry_program`` gives the step and its arguments as meta DTensors;
the step runs once, as rank 0, under a dispatch mode that sees every local
op DTensor issues (a DTensor op itself is passed on to DTensor, so what
is counted is rank 0's own share) and every collective, whether a DTensor
redistribution (functional collectives) or a plain c10d call (the graph
engine's).  One JSON record per cell, ``<arch>__<shape>__<mesh>.json``,
keeps the reference's keys:

  * ``memory.argument_size_in_bytes``: rank 0's local bytes of the
    arguments (parameters, optimizer state, batch, cache);
    ``output_size_in_bytes`` those of the step's results,
    ``alias_size_in_bytes`` the part of them that is an argument's storage
    (updated in place); ``peak_memory_in_bytes`` the most bytes live at once
    during the step (every storage an op creates counts from the op to its
    release; arguments count throughout), ``temp_size_in_bytes`` the peak
    less the arguments; ``live_bytes_est`` is the peak, and ``fits`` says
    whether it is at most ``hbm_bytes`` (the card's memory, else
    ``--hbm-bytes``; ``null`` with neither);
  * ``cost.flops_per_device``: FLOPs of rank 0's local ops by
    ``torch.utils.flop_counter``'s formulas (matrix products, convolutions,
    attention; elementwise ops count none);
  * ``cost.bytes_accessed_per_device``: the bytes of every tensor operand
    and result of every local aten op that is not a view, op by op, with no
    fusion;
  * ``collectives``: per kind, ``count``, ``payload_bytes`` (the
    collective's result bytes on the rank) and ``wire_bytes`` by the
    reference's ring model (``wire_bytes``), summed in
    ``collective_wire_bytes_per_device``;
  * ``model_flops_global``: the family's ``model_flops``.

Cells run in one worker process per core the command may use (each with
its own fake group).  A cell whose step raises records ``status: "error"``
with its traceback, and the command exits 1 if any cell did.  ``V5E`` (a TPU's constants) has
no counterpart: ``fits`` is against the memory of the card the run is on.
The fake process group is internal PyTorch API and is imported here only.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out DIR
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import weakref
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_arch, list_archs
from repro_torch.launch.mesh import make_production_mesh

_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional",
                          "_c10d_functional_autograd", "c10d")
# op names (leading and trailing "_" stripped) -> the reference's kinds
_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "allreduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather": "all-gather",
    "allgather_base": "all-gather", "allgather_coalesced": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter": "reduce-scatter",
    "reduce_scatter_base": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall": "all-to-all",
    "alltoall_base": "all-to-all",
}
_NOT_COLLECTIVES = {"wait_tensor", "wrap_tensor_autograd", "barrier", "monitored_barrier"}


def wire_bytes(kind: str, payload: float, k: int) -> float:
    """Modelled bytes a rank puts on the wire for one collective over ``k``
    ranks whose result on the rank is ``payload`` bytes (ring algorithms,
    the reference's ``parse_collectives``): all-reduce 2p(k-1)/k,
    all-gather and all-to-all p(k-1)/k, reduce-scatter p(k-1) (its input is
    k results), a permute p."""
    k = max(int(k), 1)
    if kind == "all-reduce":
        return 2 * payload * (k - 1) / k
    if kind in ("all-gather", "all-to-all"):
        return payload * (k - 1) / k
    if kind == "reduce-scatter":
        return payload * (k - 1)
    return payload


def _tensors(obj):
    """Every tensor in a tree of dicts, lists, tuples and modules; a
    DTensor as its local shard."""
    from torch.distributed.tensor import DTensor

    if isinstance(obj, DTensor):
        yield obj.to_local()
    elif isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from _tensors(list(obj.parameters()))
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _storages(obj):
    """The distinct storages of ``obj``'s tensors: {key: (storage, bytes)}."""
    out = {}
    for t in _tensors(obj):
        st = t.untyped_storage()
        out[st._cdata] = (st, st.nbytes())
    return out


def _group_size(func, args, kwargs) -> int:
    """The number of ranks a collective op runs over, from its schema's
    ``group_size``, ``group_name`` or ``process_group`` argument."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    named = dict(kwargs)
    for arg, value in zip(func._schema.arguments, args):
        named[arg.name] = value
    if "group_size" in named:
        return int(named["group_size"])
    if "group_name" in named:
        return _resolve_process_group(named["group_name"]).size()
    if "process_group" in named:
        return dist.ProcessGroup.unbox(named["process_group"]).size()
    raise ValueError(f"{func}: no group argument")


class StepCounter(TorchDispatchMode):
    """Counts one rank's local ops while a step runs: FLOPs, bytes
    accessed, collectives, and the live bytes of every storage (a storage
    counts from the op that makes it to its release).  An op on DTensors
    returns ``NotImplemented`` here, so DTensor runs it and the local ops
    and collectives it issues come back through this mode."""

    def __init__(self, arguments=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives = {}
        self._live = {}
        self.live_bytes = 0
        for key, (st, n) in _storages(arguments).items():
            self._track(key, st, n)
        self.peak_bytes = self.live_bytes

    def _track(self, key, st, nbytes):
        if key in self._live:
            return
        self._live[key] = weakref.ref(st, lambda _, key=key, n=nbytes: self._release(key, n))
        self.live_bytes += nbytes

    def _release(self, key, nbytes):
        if self._live.pop(key, None) is not None:
            self.live_bytes -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in_shape_propagation():
            return out
        if isinstance(func, torch._ops.OpOverload):
            self._count(func, args, kwargs, out)
        for t in _tensors(out):
            st = t.untyped_storage()
            self._track(st._cdata, st, st.nbytes())
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out

    def _count(self, func, args, kwargs, out):
        if func.namespace in _COLLECTIVE_NAMESPACES:
            name = func._schema.name.split("::")[-1].strip("_")
            if name in _NOT_COLLECTIVES:
                return
            kind = _COLLECTIVE_KINDS.get(name)
            if kind is None:
                raise ValueError(f"the dry run has no wire model for {func}")
            results = list(_tensors(out)) or list(_tensors(args))[:1]
            payload = sum(t.numel() * t.element_size() for t in results)
            k = _group_size(func, args, kwargs)
            s = self.collectives.setdefault(kind, dict(count=0, payload_bytes=0,
                                                       wire_bytes=0.0))
            s["count"] += 1
            s["payload_bytes"] += payload
            s["wire_bytes"] += wire_bytes(kind, payload, k)
            return
        formula = self._flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not func.is_view:
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in _tensors((args, kwargs, out)))


def _in_shape_propagation() -> bool:
    """Whether a fake-tensor mode is active: DTensor infers an op's output
    shape by running it on fake tensors of the global shapes, through this
    mode too; those calls are not the rank's work."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


def _fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0 (any
    group before it is destroyed)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def card_memory() -> Optional[int]:
    """The first card's memory in bytes, or None without a card."""
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.get_device_properties(0).total_memory)


def run_cell(arch_id: str, shape: str, mesh_kind: str, out_dir: str,
             hbm_bytes: Optional[int] = None):
    """Run one cell and write its record; returns the record."""
    multi = mesh_kind == "multi"
    _fake_group(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
    spec = get_arch(arch_id)
    cell = spec.cells[shape]
    rec = dict(
        arch=arch_id, shape=shape, mesh=mesh_kind,
        mesh_shape=[int(s) for s in mesh.shape], axis_names=list(mesh.mesh_dim_names),
        n_devices=int(mesh.size()), kind=cell.kind, meta=cell.meta,
        timestamp=time.time(),
    )
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{arch_id}__{shape}__{mesh_kind}.json")
    if cell.skip:
        rec.update(status="skipped", skip_reason=cell.skip)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[SKIP] {arch_id} x {shape} x {mesh_kind}: {cell.skip}")
        return rec

    try:
        t0 = time.time()
        fn, args = spec.dry_program(shape, mesh)
        t_build = time.time() - t0
        arguments = _storages(args)
        t0 = time.time()
        with StepCounter(args) as counter:
            out = fn(*args)
        t_step = time.time() - t0
        outputs = _storages(out)
        arg_bytes = sum(n for _, n in arguments.values())
        mem = {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": sum(n for _, n in outputs.values()),
            "alias_size_in_bytes": sum(n for k, (_, n) in outputs.items() if k in arguments),
            "peak_memory_in_bytes": counter.peak_bytes,
            "temp_size_in_bytes": counter.peak_bytes - arg_bytes,
            "live_bytes_est": counter.peak_bytes,
            "hbm_bytes": hbm_bytes,
            "fits": None if hbm_bytes is None else counter.peak_bytes <= hbm_bytes,
        }
        rec.update(
            status="ok", build_seconds=t_build, step_seconds=t_step, memory=mem,
            cost={"flops_per_device": float(counter.flops),
                  "bytes_accessed_per_device": float(counter.bytes_accessed)},
            collectives=counter.collectives,
            collective_wire_bytes_per_device=sum(
                c["wire_bytes"] for c in counter.collectives.values()),
            model_flops_global=float(spec.model_flops(shape)),
        )
        print(f"[OK]   {arch_id} x {shape} x {mesh_kind}: step {t_step:.1f}s "
              f"args/dev {arg_bytes / 2**30:.2f} GiB peak/dev "
              f"{counter.peak_bytes / 2**30:.2f} GiB flops/dev {counter.flops:.3e} "
              f"wire/dev {rec['collective_wire_bytes_per_device'] / 2**20:.1f} MiB")
    except Exception as e:  # noqa: BLE001 — record the failure, keep the sweep going
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {arch_id} x {shape} x {mesh_kind}: {rec['error']}")
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", type=str, default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", type=str,
                    default=os.environ.get("DRYRUN_OUT", "experiments/dryrun_torch"))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--hbm-bytes", type=int, default=None,
                    help="per-device memory for 'fits' when no card is present")
    args = ap.parse_args(argv)

    if args.list:
        for a in list_archs():
            print(a, "->", ", ".join(get_arch(a).cells))
        return 0

    hbm = card_memory()
    hbm = args.hbm_bytes if hbm is None else hbm
    archs = list_archs() if args.all or args.arch is None else [args.arch]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    # the cells mesh by mesh (a worker keeps its fake group while the mesh
    # size stays)
    cells = []
    for mk in meshes:
        for arch_id in archs:
            for shape in [args.shape] if args.shape else list(get_arch(arch_id).cells):
                out_path = os.path.join(args.out, f"{arch_id}__{shape}__{mk}.json")
                if args.skip_existing and os.path.exists(out_path):
                    with open(out_path) as f:
                        if json.load(f).get("status") in ("ok", "skipped"):
                            print(f"[CACHED] {arch_id} x {shape} x {mk}")
                            continue
                cells.append((arch_id, shape, mk, args.out, hbm))
    # one worker process per core the run may use, each with its own fake group
    jobs = min(len(os.sched_getaffinity(0)), len(cells))
    if jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        # the language models' multi-pod train and prefill cells take the
        # longest: they start first
        cells.sort(key=lambda c: -(get_arch(c[0]).family == "lm") * (
            (c[2] == "multi") + (get_arch(c[0]).cells[c[1]].kind != "decode")))
        with ProcessPoolExecutor(jobs,
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            statuses = list(ex.map(_cell_status, cells))
    else:
        statuses = [_cell_status(c) for c in cells]
        if dist.is_initialized():
            dist.destroy_process_group()
    return 1 if "error" in statuses else 0


def _cell_status(cell) -> str:
    sys.stdout.flush()
    status = run_cell(*cell).get("status")
    sys.stdout.flush()
    return status


if __name__ == "__main__":
    sys.exit(main())
