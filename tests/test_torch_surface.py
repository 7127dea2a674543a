"""The port's public surface against the reference's, read from its source.

For every module of ``src/repro/`` the port must have a module at the same
dotted path under ``repro_torch``, and in it every public function, class and
module-level constant that the reference module defines (an ``__init__``
module: every public name it re-exports). Each parameter of a public function
or method must exist in the port, at the reference's position wherever the
reference takes it positionally, with the reference's literal default. The
fields of each dataclass and NamedTuple must carry the reference's names in
the reference's order; the port may add fields only after them, each one
listed in ``ALLOWED``.

The reference is read with ``ast`` and never imported here: importing some of
its modules has side effects on the process (``repro/launch/dryrun.py`` sets
``XLA_FLAGS``). The port's modules are imported and read with ``inspect`` and
``dataclasses``.

``ALLOWED`` is the one list of what the port leaves out, spells otherwise or
adds to a reference dataclass, one entry each with its reason: the JAX
mechanisms, the tests' oracles, the port's idiom and its extra fields.
``test_allowlist_is_not_stale`` keeps every entry naming a difference that
still exists.

Run as a script, the module prints every difference, allowed or not.
"""
import ast
import dataclasses
import importlib
import inspect
import pathlib

import jax.numpy as jnp
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_ROOT = ROOT / "src" / "repro"

# ---------------------------------------------------------------------------
# The allowlist: (reference module, member or member.parameter) -> reason.
# A member "*" stands for the whole module.
# ---------------------------------------------------------------------------
_LOWERABLE = ("XLA lowering for the dry run; the port's counterpart is "
              "dry_program, run eagerly on meta tensors")
_PALLAS = "a Pallas interpret or tiling parameter; the CUDA kernels pick their own"
_MODEL = "the port's LM object (weights and config) takes the place of params, cfg"
_GENERATOR = "a torch.Generator takes the place of a JAX key"
_LADDER = ("run_laddered takes the FixpointRunner, which holds the view, "
           "windows, valid mask, plan and round cap")
_DELTA = ("no delta_budget: a delta advance writes exactly "
          "[lo_prev + C, lo_new + C) (ROADMAP Queue 3, deliberate differences)")

ALLOWED = {
    # -- JAX mechanisms ----------------------------------------------------
    ("repro.distributed.compat", "*"): "JAX version shims (make_mesh, shard_map); the port calls torch.distributed",
    ("repro.launch.mesh", "V5E"): "a TPU's roofline constants; fits reads the card's memory",
    ("repro.configs.base", "ArchSpec.lowerable"): _LOWERABLE,
    ("repro.configs.families", "LMFamily.lowerable"): _LOWERABLE,
    ("repro.configs.families", "GNNFamily.lowerable"): _LOWERABLE,
    ("repro.configs.families", "NequIPFamily.lowerable"): _LOWERABLE,
    ("repro.configs.families", "RecsysFamily.lowerable"): _LOWERABLE,
    ("repro.configs.kairos", "KairosFamily.lowerable"): _LOWERABLE,
    ("repro.configs.families", "LMFamily.layer_scaled_lowerable"): "XLA's cost analysis counts a scan body once; an eager step counts every layer",
    ("repro.models.transformer", "LMConfig.unroll"): "the unroll of the lax.scan over layers; the port loops in Python",
    ("repro.train.train_step", "jit_train_step"): "a jax.jit wrapper; the port's step runs eagerly",
    ("repro.engine.frontier", "ladder_trace_log"): "a JAX retrace counter; the port does not trace",
    ("repro.engine.frontier", "ladder_trace_count"): "a JAX retrace counter; the port does not trace",
    ("repro.serve.window_sweep", "fused_trace_count"): "a JAX retrace counter; the port does not trace",
    ("repro.serve", "fused_trace_count"): "a JAX retrace counter; the port does not trace",
    ("repro.launch.dryrun", "OUT_DIR"): "the HLO dump directory; the port's CLI takes --out (DRYRUN_OUT)",
    ("repro.launch.dryrun", "parse_collectives"): "parses compiled HLO text; the port counts collectives by a dispatch mode",
    ("repro.launch.dryrun", "run_cell.save_hlo"): "saves compiled HLO text; the port compiles none",
    ("repro.kernels.decode_attention", "decode_attention_pallas"): "the Pallas K4; the port's K4 is decode_attention in the same module",
    ("repro.engine.backends", "PallasTiledBackend.__init__.interpret"): _PALLAS,
    ("repro.kernels.ops", "relax_min.interpret"): _PALLAS,
    ("repro.kernels.ops", "earliest_arrival_kernel.interpret"): _PALLAS,
    ("repro.kernels.ops", "spmm.tile_v"): _PALLAS,
    ("repro.kernels.ops", "spmm.block_e"): _PALLAS,
    ("repro.kernels.ops", "spmm.interpret"): _PALLAS,
    ("repro.kernels.segment_spmm", "segment_spmm_tiles.tile_d"): _PALLAS,
    ("repro.kernels.segment_spmm", "segment_spmm_tiles.interpret"): _PALLAS,
    ("repro.kernels.temporal_edgemap", "temporal_relax_min_tiles.chunk"): _PALLAS,
    ("repro.kernels.temporal_edgemap", "temporal_relax_min_tiles.interpret"): _PALLAS,
    ("repro.kernels.temporal_edgemap", "segment_min_tiles.chunk"): _PALLAS,
    ("repro.kernels.temporal_edgemap", "segment_min_tiles.interpret"): _PALLAS,
    # -- the tests' oracles --------------------------------------------------
    ("repro.core.reference", "*"): "numpy oracles; the port's tests call the reference's directly",
    # -- the port's idiom -----------------------------------------------------
    ("repro.models.transformer", "init_params"): "init_lm(cfg, generator) builds the LM object",
    ("repro.models.transformer", "forward.params"): _MODEL,
    ("repro.models.transformer", "forward.cfg"): _MODEL,
    ("repro.models.transformer", "loss_fn.params"): _MODEL,
    ("repro.models.transformer", "loss_fn.cfg"): _MODEL,
    ("repro.models.transformer", "loss_fn.aux_weight"): "one place earlier: " + _MODEL,
    ("repro.models.transformer", "prefill.params"): _MODEL,
    ("repro.models.transformer", "prefill.cfg"): _MODEL,
    ("repro.models.transformer", "prefill.max_seq"): "one place earlier: " + _MODEL,
    ("repro.models.transformer", "decode_step.params"): _MODEL,
    ("repro.models.transformer", "decode_step.cfg"): _MODEL,
    ("repro.serve.engine", "ServeEngine.__init__.params"): _MODEL,
    ("repro.serve.engine", "ServeEngine.__init__.cfg"): _MODEL,
    ("repro.serve.engine", "ServeEngine.__init__.batch_slots"): "one place earlier: " + _MODEL,
    ("repro.serve.engine", "ServeEngine.__init__.max_seq"): "one place earlier: " + _MODEL,
    ("repro.serve.engine", "ServeEngine.__init__.eos_id"): "one place earlier: " + _MODEL,
    ("repro.models.layers", "dense_init.key"): _GENERATOR,
    ("repro.models.moe", "init_moe.key"): _GENERATOR,
    ("repro.models.gnn", "init_gnn.key"): _GENERATOR + ", after cfg (init_gnn(cfg, generator))",
    ("repro.models.gnn", "init_gnn.cfg"): "first, before the generator, as the port's init_* take it",
    ("repro.models.mind", "init_mind.key"): _GENERATOR + ", after cfg (init_mind(cfg, generator))",
    ("repro.models.mind", "init_mind.cfg"): "first, before the generator, as the port's init_* take it",
    ("repro.models.nequip", "init_nequip.key"): _GENERATOR + ", after cfg (init_nequip(cfg, generator))",
    ("repro.models.nequip", "init_nequip.cfg"): "first, before the generator, as the port's init_* take it",
    ("repro.engine.frontier", "run_laddered.edges"): _LADDER,
    ("repro.engine.frontier", "run_laddered.windows"): _LADDER,
    ("repro.engine.frontier", "run_laddered.valid"): _LADDER,
    ("repro.engine.frontier", "run_laddered.plan"): _LADDER,
    ("repro.engine.frontier", "run_laddered.n_vertices"): _LADDER,
    ("repro.engine.frontier", "run_laddered.max_rounds"): _LADDER,
    ("repro.engine.frontier", "run_laddered.state"): "third, after the runner: " + _LADDER,
    ("repro.engine.frontier", "ladder_eligible.edges"): "read only to refuse traced calls; the port has none",
    ("repro.train.elastic", "build_mesh_from_plan.devices"): "device= (the card of this rank); the process group names the ranks",
    # -- deliberate differences (ROADMAP Queue 3) ---------------------------
    ("repro.core.edgemap", "advance_index_ring.delta_budget"): _DELTA,
    ("repro.core.edgemap", "advance_index_ring_fields.delta_budget"): _DELTA,
    ("repro.core.edgemap", "advance_hybrid_ring.delta_budget"): _DELTA,
    ("repro.core.edgemap", "advance_hybrid_ring_fields.delta_budget"): _DELTA,
    # -- the port's extra fields ---------------------------------------------
    ("repro.serve.window_sweep", "SweepState.consumed"): "a later advance took the state's ring, written in place (the reference donates it)",
}


# ---------------------------------------------------------------------------
# The reference's surface, from its source
# ---------------------------------------------------------------------------
def ref_modules():
    """Dotted names of every module of the reference package."""
    names = []
    for path in sorted(REF_ROOT.rglob("*.py")):
        parts = path.relative_to(REF_ROOT.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def _ref_path(module: str) -> pathlib.Path:
    rel = pathlib.Path(*module.split(".")[1:])
    pkg = REF_ROOT / rel / "__init__.py"
    return pkg if pkg.exists() else (REF_ROOT / rel).with_suffix(".py")


def _public(name: str) -> bool:
    return not name.startswith("_")


def _dotted(node) -> str:
    if isinstance(node, ast.Call):
        node = node.func
    if isinstance(node, ast.Attribute):
        return _dotted(node.value) + "." + node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


_NO_LITERAL = object()


def _literal(node):
    try:
        return ast.literal_eval(node)
    except (ValueError, TypeError, SyntaxError):
        return _NO_LITERAL


def _params(fn: ast.FunctionDef):
    """(positional names in order, keyword-only names, {name: literal
    default}) of a def; defaults that are not literals are left out."""
    a = fn.args
    pos = [p.arg for p in a.posonlyargs + a.args]
    defaults = dict(zip(pos[len(pos) - len(a.defaults):], map(_literal, a.defaults)))
    defaults.update((p.arg, _literal(d)) for p, d in zip(a.kwonlyargs, a.kw_defaults)
                    if d is not None)
    return pos, [p.arg for p in a.kwonlyargs], {
        k: v for k, v in defaults.items() if v is not _NO_LITERAL}


def _is_property(fn) -> bool:
    return any(_dotted(d).endswith(("property", "cached_property"))
               for d in fn.decorator_list)


def _fields(cls: ast.ClassDef):
    """{field name: literal default or _NO_LITERAL} in order, of a dataclass
    or NamedTuple, else None."""
    decos = {_dotted(d) for d in cls.decorator_list}
    bases = {_dotted(b) for b in cls.bases}
    if not ({"dataclasses.dataclass", "dataclass"} & decos
            or {"NamedTuple", "typing.NamedTuple"} & bases):
        return None
    out = {}
    for stmt in cls.body:
        if (isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name)
                and "ClassVar" not in ast.unparse(stmt.annotation)):
            out[stmt.target.id] = (_NO_LITERAL if stmt.value is None
                                   else _literal(stmt.value))
    return out


def ref_surface(module: str) -> dict:
    """{member name: description} of one reference module.

    A description is ("function", positional, keyword-only, defaults),
    ("class", fields or None, {method: (positional, keyword-only,
    defaults)}, attribute names), ("constant",) or ("export",): a name an
    ``__init__`` module imports or a module lists in ``__all__``.
    """
    tree = ast.parse(_ref_path(module).read_text())
    is_package = _ref_path(module).name == "__init__.py"
    out = {}
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _public(stmt.name):
                out[stmt.name] = ("function", *_params(stmt))
        elif isinstance(stmt, ast.ClassDef):
            if not _public(stmt.name):
                continue
            methods, attrs = {}, []
            for s in stmt.body:
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if _is_property(s):
                        attrs += [s.name] if _public(s.name) else []
                    elif _public(s.name) or s.name in ("__init__", "__call__"):
                        methods[s.name] = _params(s)
                elif isinstance(s, ast.Assign):
                    attrs += [t.id for t in s.targets
                              if isinstance(t, ast.Name) and _public(t.id)]
            out[stmt.name] = ("class", _fields(stmt), methods, attrs)
        elif isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    for name in ast.literal_eval(stmt.value):
                        out.setdefault(name, ("export",))
                    out["__all__"] = ("all", ast.literal_eval(stmt.value))
                elif isinstance(t, ast.Name) and _public(t.id):
                    out[t.id] = ("constant",)
        elif isinstance(stmt, ast.ImportFrom) and is_package:
            for alias in stmt.names:
                name = alias.asname or alias.name
                if _public(name) and name not in out:
                    out[name] = ("export",)
    return out


# ---------------------------------------------------------------------------
# The port's surface, by import
# ---------------------------------------------------------------------------
def port_name(module: str) -> str:
    return "repro_torch" + module[len("repro"):]


def _port_params(obj):
    """(positional names in order, every name accepted by keyword,
    {name: default})."""
    if isinstance(obj, (staticmethod, classmethod)):
        obj = obj.__func__
    if isinstance(obj, property):
        return None
    try:
        sig = inspect.signature(obj, follow_wrapped=True)
    except (TypeError, ValueError):
        return None
    pos = [p.name for p in sig.parameters.values()
           if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    kw = {p.name for p in sig.parameters.values()
          if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}
    defaults = {p.name: p.default for p in sig.parameters.values()
                if p.default is not p.empty}
    return pos, kw, defaults


def _same_value(a, b) -> bool:
    return type(a) is type(b) and (a == b or a != a and b != b)


def _port_fields(cls):
    """{field name: default (dataclasses.MISSING if none)} in order, or None."""
    if dataclasses.is_dataclass(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}
    names = getattr(cls, "_fields", None)
    if not names:
        return None
    return {n: cls._field_defaults.get(n, dataclasses.MISSING) for n in names}


def _compare_params(key, ref, port, out):
    ref_pos, ref_kw, ref_defaults = ref
    if port is None:
        out[key] = "has no signature in the port"
        return
    port_pos, port_kw, port_defaults = port
    for i, name in enumerate(ref_pos):
        if i < len(port_pos) and port_pos[i] == name:
            continue
        if name in port_kw or name in port_pos:
            out[f"{key}.{name}"] = (f"positional {i} in the reference, "
                                    f"{port_pos.index(name) if name in port_pos else 'keyword'} "
                                    "in the port")
        else:
            out[f"{key}.{name}"] = "parameter missing in the port"
    for name in ref_kw:
        if name not in port_kw:
            out[f"{key}.{name}"] = "keyword parameter missing in the port"
    for name, value in ref_defaults.items():
        got = port_defaults.get(name, inspect.Parameter.empty)
        if f"{key}.{name}" not in out and not _same_value(value, got):
            out[f"{key}.{name}"] = f"default {got!r} in the port, {value!r} in the reference"


def divergences(module: str) -> dict:
    """{member key: what differs} between a reference module and the port's."""
    try:
        port = importlib.import_module(port_name(module))
    except ModuleNotFoundError:
        return {"*": f"no module {port_name(module)}"}
    out = {}
    for name, desc in ref_surface(module).items():
        if not hasattr(port, name):
            out[name] = f"{desc[0]} missing in the port"
            continue
        obj = getattr(port, name)
        if desc[0] == "all":
            for n in desc[1]:
                if n not in obj and n not in out:
                    out[n] = "not in the port's __all__"
        elif desc[0] == "function":
            _compare_params(name, desc[1:], _port_params(obj), out)
        elif desc[0] == "class":
            _, fields, methods, attrs = desc
            if fields is not None:
                got = _port_fields(obj) or {}
                shared = [f for f in fields if f in got]
                if list(got)[:len(shared)] != shared:
                    out[f"{name}.<fields>"] = (f"fields {list(got)} in the port, "
                                               f"{list(fields)} in the reference")
                for field in got:
                    if field not in fields:
                        out[f"{name}.{field}"] = "field the port adds after the reference's"
                for field, value in fields.items():
                    if field not in got:
                        out[f"{name}.{field}"] = "field missing in the port"
                    elif value is not _NO_LITERAL and not _same_value(
                            value, got[field]):
                        out[f"{name}.{field}"] = (f"default {got[field]!r} in the "
                                                  f"port, {value!r} in the reference")
            for meth, params in methods.items():
                if meth == "__init__" and fields is not None:
                    continue
                try:
                    attr = inspect.getattr_static(obj, meth)
                except AttributeError:
                    out[f"{name}.{meth}"] = "method missing in the port"
                    continue
                _compare_params(f"{name}.{meth}", params, _port_params(attr), out)
            for attr in attrs:
                if not hasattr(obj, attr):
                    out[f"{name}.{attr}"] = "class attribute missing in the port"
    return out


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------
MODULES = ref_modules()


@pytest.mark.parametrize("module", MODULES)
def test_port_has_the_reference_surface(module):
    """Every divergence of the module's surface is on the allowlist."""
    left = {k: v for k, v in divergences(module).items() if (module, k) not in ALLOWED}
    assert not left, "\n".join(f"{module}: {k}: {v}" for k, v in left.items())


def test_allowlist_is_not_stale():
    """Each entry names a difference that still exists (something the
    reference has and the port lacks or spells otherwise, or a field the
    port adds) and gives its reason."""
    found = {(m, k) for m in MODULES for k in divergences(m)}
    stale = [key for key in ALLOWED if key not in found]
    assert not stale, stale
    assert all(isinstance(r, str) and r.strip() for r in ALLOWED.values())


# The constants both packages share, with the reference module holding each.
# Only modules that the port's tests already import are imported here.
CONSTANTS = [
    ("repro.engine.backends", "INT_INF"),
    ("repro.kernels.temporal_edgemap", "INT_INF"),
    ("repro.kernels.ref", "INT_INF"),
    ("repro.core.edgemap", "INT_INF"),
    ("repro.core.edgemap", "FLOAT_INF"),
    ("repro.core.algorithms.paths", "INT_NEG_INF"),
    ("repro.core.temporal_graph", "INF_TIME"),
    ("repro.kernels.decode_attention", "NEG_INF"),
]


@pytest.mark.parametrize("module,name", CONSTANTS, ids=[f"{m}.{n}" for m, n in CONSTANTS])
def test_constant_values_equal_the_reference(module, name):
    importlib.import_module("repro.core")  # the JAX package imports core before engine
    ref = getattr(importlib.import_module(module), name)
    port = getattr(importlib.import_module(port_name(module)), name)
    assert isinstance(port, (int, float)) and port == ref, (port, ref)


def test_dtype_constants_equal_the_reference():
    ref = importlib.import_module("repro.configs.kairos")
    port = importlib.import_module("repro_torch.configs.kairos")
    for name in ("I32", "F32"):
        assert str(getattr(port, name)) == "torch." + jnp.dtype(getattr(ref, name)).name
    assert (port.I32, port.F32) == (torch.int32, torch.float32)


if __name__ == "__main__":
    for m in MODULES:
        for k, v in divergences(m).items():
            print(f"{m}\t{k}\t{v}\t{'allowed' if (m, k) in ALLOWED else 'DIVERGES'}")
