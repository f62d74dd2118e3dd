"""The port's public surface against the reference's, name by name.

Both trees are parsed with ``ast``; neither package is imported, so the
test needs no JAX and runs in seconds. For every module under
``src/repro/`` the port's module at the same relative path must exist and
hold every public top-level ``def``, ``class``, assignment and
``from ... import ... as`` name, every public method, property and
annotated field of a public class, and every parameter of a public
function or method. What the port deliberately lacks stands in
``LEFT_OUT`` with its reason; this table is the one list of what the port
leaves out (ROADMAP.md §1 points here).

An entry is ``module`` (the whole module), ``module::name`` (a name, with
its members and parameters) or ``module::function(param)``; the module
and the name may hold ``fnmatch`` wildcards. An entry that matches nothing
the port lacks fails, so the table cannot go stale.
"""
from __future__ import annotations

import ast
from fnmatch import fnmatch
from functools import lru_cache
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

ONE_CARD = ("one card: the PE ring is a leading tensor dimension of `n_pe` "
            "PEs, so no mesh, mesh axis, device count or sharding spec "
            "crosses an interface")
REPUBLISH = ("nothing crosses a `shard_map`: the helpers that carry "
             "counters out of one have no counterpart, and the port's "
             "totals equal what `device_sum` gives")
JAX_ONLY = ("JAX machinery with no PyTorch counterpart: pytree "
            "registration, `lax.scan` and its unroll, `jax.random` keys "
            "(the port takes a `torch.Generator` or a seed) and version "
            "shims")
PALLAS = ("Pallas plumbing: the CUDA kernels choose their own tiles "
          "(`kernel_block` reaches `tile_matmul` as `block`) and have no "
          "interpret mode; on the CPU a wrapper runs its plain twin")
USE_KERNEL = "`use_kernel`: the port's rings always call their kernels"
ORACLES = ("the kernels' `ref.py` oracles: the port's tests call the "
           "reference's own")
UNCALLED = ("called by no module of the reference; the port's counterparts are "
            "`flash_carry(..., normalize=True)` from `ops.zero_state` and "
            "`tile_matmul`")
HLO = ("XLA HLO: the port counts aten ops and kernel launches on fake "
       "tensors (`roofline/count.py`) in place of lowering a cell and "
       "parsing its HLO, so `analyze_cell` takes the record or its path "
       "(`record`)")
TPU = ("figures of a TPU and its links, which the port does not state: "
       "`roofline/hw.py` holds the H100's (`PEAK_FLOPS`, `HBM_BW`, "
       "`HBM_BYTES`)")
ALL_PES = ("every PE at once: an element carries the PE dimension first, "
           "so no PE index is passed, a PE block's halo rows come as `top` "
           "and `bot`, and ring decode reads the global cache in place (`k_cache`, "
           "`v_cache`, `pos`)")
KERNEL_ARGS = ("the Hopper kernels' own operands: `flash_carry` takes "
               "per-row offsets (`q_off`, `k_off`), `fft_stage` complex64 "
               "`x`, and `ops.tile_matmul` is the matmul's entry "
               "(`kernel.py` holds `matmul_cuda` and `matmul_plain`)")
TOKENS = ("the models' `hidden_states` and `prefill` take `tokens` (and "
          "`patch_embeds`) in place of a `batch` dict")
MOE_LAYER = ("a block's parameters say whether it is an MoE layer "
             "(`\"moe\" in lp`)")
SCAN_LAYERS = "`scan_layers` is `lax.scan` over stacked layers"
UNREAD = "used by no module of the reference"
UNPASSED = ("a parameter that no module of the reference passes; every "
            "caller takes its default")
TRACED_ENABLE = ("the reference scales each delta by an enable that may be "
                 "traced; the port's `StatsScope` holds a host flag and "
                 "records a delta or not")
CACHE_FILE = ("the default tuning cache is `DEFAULT_FILE`, the committed "
              "H100 file beside the module, not a name in the working "
              "directory")
IMPORT_ALIAS = "a module alias: the port imports `tile_matmul` itself"

LEFT_OUT = {
    # one card
    "launch/mesh.py": ONE_CARD,
    "sharding/*.py": ONE_CARD,
    "configs/base.py::MeshConfig": ONE_CARD,
    "configs/base.py::ModelConfig.parallelism": ONE_CARD,
    "configs/base.py::ModelConfig.sequence_parallel": ONE_CARD,
    "*::*(mesh)": ONE_CARD,
    "core/fft.py::pipelined_fft(axis)": ONE_CARD,
    "core/halo.py::*(axis)": ONE_CARD,
    "core/pipeline.py::pipelined(axis)": ONE_CARD,
    "core/queues.py::*(axis)": ONE_CARD,
    "*::P": ONE_CARD,
    "autotune/space.py::candidates(n_devices)": ONE_CARD,
    "launch/dryrun.py::run_cell(multi_pod)": ONE_CARD,
    "roofline/analysis.py::run(mesh_filter)": ONE_CARD,
    "serve/sharded_cache.py::RingShardedBackend.__init__(param_axes)":
        ONE_CARD,
    "train/optimizer.py::opt_state_axes": ONE_CARD,
    "train/step.py::model_input_specs": ONE_CARD,
    "models/common.py::Param": ONE_CARD,
    "models/common.py::is_param": ONE_CARD,
    "models/common.py::split_tree": ONE_CARD,
    "models/common.py::param(axes)": ONE_CARD,
    "models/common.py::*_RULES": ONE_CARD,
    "models/common.py::rules_for": ONE_CARD,
    "models/common.py::ShardCtx": ONE_CARD,
    "models/common.py::current_ctx": ONE_CARD,
    "models/common.py::use_sharding": ONE_CARD,
    "models/common.py::resolve_spec": ONE_CARD,
    "models/common.py::spec_for": ONE_CARD,
    "models/common.py::shard": ONE_CARD,
    "models/common.py::shard_residual": ONE_CARD,
    # shard_map republishing
    "obs/linkstats.py::stats_specs": REPUBLISH,
    "obs/linkstats.py::expand": REPUBLISH,
    "obs/linkstats.py::device_sum": REPUBLISH,
    "obs/linkstats.py::instrumented": REPUBLISH,
    "obs/linkstats.py::absorb": REPUBLISH,
    "obs/linkstats.py::shard_call": REPUBLISH,
    "obs/linkstats.py::scan": REPUBLISH,
    "obs/linkstats.py::StatsScope.merge": REPUBLISH,
    "obs/linkstats.py::LinkStats.scale": TRACED_ENABLE,
    # JAX
    "compat.py": JAX_ONLY,
    "*::*.tree_flatten": JAX_ONLY,
    "*::*.tree_unflatten": JAX_ONLY,
    "*::*(key)": JAX_ONLY,
    "models/common.py::stack_init": JAX_ONLY,
    "core/queues.py::stream*(unroll)": JAX_ONLY,
    "configs/base.py::ModelConfig.scan_layers": SCAN_LAYERS,
    # Pallas
    "kernels/*::pl": PALLAS,
    "kernels/*::pltpu": PALLAS,
    "kernels/*::largest_dividing_block": PALLAS,
    "kernels/*::*(b[mnkq])": PALLAS,
    "kernels/*::*(bkv)": PALLAS,
    "kernels/*::*(bb)": PALLAS,
    "kernels/*::*(interpret)": PALLAS,
    "kernels/*/ref.py": ORACLES,
    "*::*(use_kernel)": USE_KERNEL,
    "configs/base.py::ModelConfig.use_kernel": USE_KERNEL,
    "kernels/flash_attention/*.py::flash_attention": UNCALLED,
    "kernels/systolic_matmul/ops.py::systolic_matmul": UNCALLED,
    "models/common.py::*dense": UNREAD,
    "configs/base.py::ModelConfig.systolic_chunks": UNREAD,
    "core/topology.py::Topology.sources": UNREAD,
    "core/topology.py::Topology.neighbors_of": UNREAD,
    "obs/linkstats.py::LinkStats.total_errors": UNREAD,
    "core/topology.py::hop_topos(n_steps)": UNPASSED,
    "models/attention.py::init_gqa(d_model)": UNPASSED,
    "models/common.py::init_mlp(d_model)": UNPASSED,
    "models/attention.py::plain_attention(?_positions)": UNPASSED,
    "models/ssm.py::mamba2_forward(assoc_scan)": UNPASSED,
    # the dry run and the roofline
    "roofline/hlo_parse.py": HLO,
    "launch/dryrun.py::lower_cell": HLO,
    "launch/dryrun.py::parse_collectives": HLO,
    "launch/dryrun.py::COLLECTIVE_OPS": HLO,
    "roofline/analysis.py::analyze_cell(json_path)": HLO,
    "roofline/hw.py::PEAK_FLOPS_BF16": TPU,
    "roofline/hw.py::HBM_PER_CHIP": TPU,
    "roofline/hw.py::ICI_LINK_BW": TPU,
    "roofline/hw.py::DCN_BW": TPU,
    "core/energy.py::TPU_V5E": TPU,
    # interfaces that take every PE, or the kernels' own operands
    "core/faults.py::apply(my)": ALL_PES,
    "core/halo.py::conv2d_3x3_local(x_halo)": ALL_PES,
    "core/ring_attention.py::ring_decode_attention(*_all)": ALL_PES,
    "kernels/flash_attention/kernel.py::flash_carry(*_pos)": KERNEL_ARGS,
    "kernels/fft/kernel.py::fft_stage(*[ri])": KERNEL_ARGS,
    "kernels/systolic_matmul/kernel.py::matmul": KERNEL_ARGS,
    # the models
    "models/*::*LM.hidden_states(batch)": TOKENS,
    "models/*::*LM.prefill(batch)": TOKENS,
    "models/transformer.py::block_*(moe_layer)": MOE_LAYER,
    "autotune/cache.py::DEFAULT_FILENAME": CACHE_FILE,
    "core/ring_moe.py::tile_ops": IMPORT_ALIAS,
}


def _body(stmts):
    """Top-level statements, with those under ``if`` and ``try`` flattened."""
    for node in stmts:
        if isinstance(node, (ast.If, ast.Try)):
            yield from _body(node.body)
            yield from _body(node.orelse)
            for handler in getattr(node, "handlers", ()):
                yield from _body(handler.body)
            yield from _body(getattr(node, "finalbody", ()))
        else:
            yield node


def _names(target):
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from _names(elt)


def _params(fn) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _public(name: str) -> bool:
    return not name.startswith("_")


def _function(owner: str, fn) -> set[str]:
    """A public function's name and its parameters; ``__init__`` gives its
    parameters only."""
    if not (_public(fn.name) or fn.name == "__init__"):
        return set()
    out = {f"{owner}({p})" for p in _params(fn)}
    return out | {owner} if _public(fn.name) else out


@lru_cache(maxsize=None)
def surface(path: Path, port: bool) -> frozenset:
    """Public items of one module: ``name``, ``Class.member`` and
    ``function(param)``. The port's side also counts plain imports and
    class-level assignments, and members inherited from a class of the same
    module, so that only what the reference has decides what is checked."""
    tree = ast.parse(path.read_text())
    out: set[str] = set()
    classes: dict[str, ast.ClassDef] = {}
    for node in _body(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _public(node.name):
                out |= _function(node.name, node)
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            out.add(node.name)
            members = list(node.body)
            if port:
                for base in node.bases:
                    if isinstance(base, ast.Name) and base.id in classes:
                        members += classes[base.id].body
            classes[node.name] = node
            for m in members:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out |= _function(f"{node.name}.{m.name}", m)
                elif isinstance(m, ast.AnnAssign) or (
                        port and isinstance(m, ast.Assign)):
                    targets = [m.target] if isinstance(m, ast.AnnAssign) \
                        else m.targets
                    out |= {f"{node.name}.{n}" for t in targets
                            for n in _names(t) if _public(n)}
        elif isinstance(node, ast.Assign):
            out |= {n for t in node.targets for n in _names(t) if _public(n)}
        elif isinstance(node, ast.AnnAssign):
            out |= {n for n in _names(node.target) if _public(n)}
        elif isinstance(node, ast.ImportFrom) or (
                port and isinstance(node, ast.Import)):
            for alias in node.names:
                if alias.asname:
                    out |= {alias.asname} if _public(alias.asname) else set()
                elif port:
                    out.add(alias.name.split(".")[0])
    return frozenset(out)


REF_MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


def _covers(entry: str, module: str, item: str | None) -> bool:
    """Whether ``entry`` leaves out ``item`` of ``module`` (None: the
    module itself)."""
    mod, _, name = entry.partition("::")
    if not fnmatch(module, mod):
        return False
    if not name:
        return True
    if item is None:
        return False
    return any(fnmatch(item, pat) for pat in (name, f"{name}.*",
                                              f"{name}(*"))


def _missing(module: str) -> set[str] | None:
    """The reference's items of ``module`` that the port lacks, or None
    when the port has no such module."""
    port = PORT / module
    if not port.exists():
        return None
    return set(surface(REF / module, False)) - surface(port, True)


@pytest.mark.parametrize("module", REF_MODULES)
def test_port_module_has_the_reference_surface(module):
    missing = _missing(module)
    if missing is None:
        assert any(_covers(e, module, None) for e in LEFT_OUT), (
            f"src/repro_torch/{module} is missing")
        return
    gaps = sorted(i for i in missing
                  if not any(_covers(e, module, i) for e in LEFT_OUT))
    assert not gaps, f"{module}: the port lacks {gaps}"


@pytest.mark.parametrize("entry", sorted(LEFT_OUT))
def test_left_out_entry_names_only_what_the_port_lacks(entry):
    """An entry must leave out something, and nothing the port has."""
    hits = 0
    for module in REF_MODULES:
        missing = _missing(module)
        if _covers(entry, module, None):
            assert missing is None, f"{entry}: the port has {module}"
            hits += 1
            continue
        for item in surface(REF / module, False):
            if _covers(entry, module, item):
                assert missing is None or item in missing, (
                    f"{entry}: the port has {module}::{item}")
                hits += 1
    assert hits, f"{entry} matches nothing in the reference"

