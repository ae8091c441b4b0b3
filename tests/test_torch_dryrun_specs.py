"""The port's dry-run layout against the JAX package's, on the CPU with no
process group: the inputs and caches as meta tensors (`Model.input_specs`,
`cache_specs_struct`) against the reference's ShapeDtypeStructs for every
arch × `SHAPES` entry, `SHAPES` and `shapes_for` entry for entry, and for
every (arch × shape × mesh) cell of the grid the plan's fields and the
params / cache / train-state bytes per device (`launch/dryrun.layout_cell`)
against the reference's own `plan_for`, `params_shardings`,
`_tree_bytes_per_device` and `jax.eval_shape` on a
`jax.sharding.AbstractMesh` of the production shape (the train state with
the block table's meter, as the reference's instrumented cell).  Exact
equality throughout: these are shapes and counts."""
import functools

import numpy as np
import pytest

from repro_torch.configs import SHAPES as PT_SHAPES
from repro_torch.configs import get_config as pt_get_config
from repro_torch.configs import reference_archs, shapes_for as pt_shapes_for
from repro_torch.launch import dryrun as PD

ARCHS = reference_archs()
CELLS = list(PD.all_cells())
FIELDS = ("tp", "dp", "eff_devices", "fsdp", "param_count",
          "active_param_count", "tokens", "microbatch",
          "params_bytes_per_device", "cache_bytes_per_device",
          "state_bytes_per_device")


def _abstract_mesh(kind):
    from jax.sharding import AbstractMesh
    if kind == "multi":
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


@functools.lru_cache(maxsize=None)
def _jax_model(arch, mode, shape_name, kind, **knobs):
    """``knobs``: config fields set as the reference's `run_cell` sets its
    ``remat`` / ``weight_quant``; the plan sees the quantized bytes."""
    import dataclasses
    from repro.configs import get_config
    from repro.distributed.sharding import plan_for
    from repro.models.model_zoo import build_model
    cfg = dataclasses.replace(get_config(arch), **knobs)
    mesh = _abstract_mesh(kind)
    bytes_per_param = {"int8": 1.0, "int4": 0.5}.get(cfg.weight_quant, 2.0)
    plan = plan_for(mesh, arch, mode, shape_name,
                    int(cfg.param_count() * bytes_per_param / 2))
    return cfg, mesh, plan, build_model(cfg, plan)


@functools.lru_cache(maxsize=None)
def _jax_table(arch, shape_name, kind, **knobs):
    from repro.configs import SHAPES
    from repro.core.blocks_lm import build_block_table
    *_, model = _jax_model(arch, "train", shape_name, kind, **knobs)
    return build_block_table(model, SHAPES[shape_name])


def _reference_layout(arch, shape_name, kind, **knobs):
    """The reference dry-run's plan fields and bytes of one cell, without
    lowering (`src/repro/launch/dryrun.py:run_cell`, lines 103-152 and the
    `_tree_bytes_per_device` calls)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import SHAPES
    from repro.distributed.sharding import params_shardings
    from repro.launch.dryrun import MICROBATCH, _tree_bytes_per_device
    from repro.models import kvcache as KC
    from repro.optim.adamw import AdamWConfig, OptState
    from repro.train.state import TrainState, init_train_state
    shape = SHAPES[shape_name]
    mode = "train" if shape.kind == "train" else "serve"
    cfg, mesh, plan, model = _jax_model(arch, mode, shape_name, kind,
                                        **knobs)
    dp = int(np.prod([mesh.shape[a] for a in plan.dp_axes])) \
        if plan.dp_axes else 1
    eff = dp * plan.tp_size
    if shape_name == "long_500k":
        eff = plan.tp_size * (int(mesh.shape.get("data", 1))
                              if cfg.family != "ssm" else 1)
    out = {"tp": plan.tp_size, "dp": dp, "eff_devices": eff,
           "fsdp": plan.lookup("embed") is not None,
           "param_count": cfg.param_count(),
           "active_param_count": cfg.active_param_count(),
           "tokens": shape.tokens}
    p_shard = params_shardings(mesh, plan, model.axes())
    if shape.kind == "train":
        mb = MICROBATCH.get(arch, 1)
        if kind == "multi":
            mb = max(1, mb // 2)
        out["microbatch"] = mb
        table = _jax_table(arch, shape_name, kind, **knobs)
        st = jax.eval_shape(lambda: init_train_state(
            model, jax.random.PRNGKey(0), AdamWConfig(), table))
        rep = NamedSharding(mesh, P())
        ss = TrainState(rep, p_shard, OptState(rep, p_shard, p_shard,
                                               p_shard), rep,
                        jax.tree.map(lambda _: rep, st.meter))
        out["state_bytes_per_device"] = _tree_bytes_per_device(st, ss)
        return out
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    cache = jax.eval_shape(lambda: model.init_cache(shape.global_batch,
                                                    shape.seq_len))
    c_shard = jax.tree.map(lambda spec: NamedSharding(mesh, spec),
                           KC.cache_specs(cache, plan),
                           is_leaf=lambda x: isinstance(x, P))
    out["params_bytes_per_device"] = _tree_bytes_per_device(params, p_shard)
    out["cache_bytes_per_device"] = _tree_bytes_per_device(cache, c_shard)
    return out


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _struct(tree):
    """{key: (shape, dtype name)} of a flat dict of tensors or structs."""
    return {k: (tuple(v.shape), _dtype_name(v.dtype))
            for k, v in tree.items()}


def test_shapes_equal_the_references_entry_for_entry():
    from repro.configs import SHAPES, get_config, shapes_for
    assert list(PT_SHAPES) == list(SHAPES)
    for name, s in SHAPES.items():
        p = PT_SHAPES[name]
        assert (p.name, p.kind, p.seq_len, p.global_batch, p.tokens) == \
            (s.name, s.kind, s.seq_len, s.global_batch, s.tokens)
    for arch in ARCHS:
        assert [s.name for s in pt_shapes_for(pt_get_config(arch))] == \
            [s.name for s in shapes_for(get_config(arch))]


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_equal_the_references(arch):
    import jax
    from repro.configs import SHAPES
    from repro_torch.distributed.sharding import plan_for
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.model_zoo import build_model
    for name, shape in SHAPES.items():
        mode = "train" if shape.kind == "train" else "serve"
        *_, jmodel = _jax_model(arch, mode, name, "single")
        cfg = PD.configure(arch)
        plan = plan_for(make_production_mesh(), arch, mode, name,
                        cfg.param_count())
        model = build_model(cfg, plan, device="meta")
        got = model.input_specs(PT_SHAPES[name])
        assert all(v.device.type == "meta" for v in got.values())
        assert _struct(got) == _struct(jmodel.input_specs(shape)), name
        cache = model.cache_specs_struct(PT_SHAPES[name])
        assert all(v.device.type == "meta" for v in cache.values())
        want = jax.eval_shape(lambda: jmodel.init_cache(shape.global_batch,
                                                        shape.seq_len))
        assert _struct(cache) == _struct(want), name


def test_cache_specs_struct_holds_the_int8_caches_scales():
    import jax
    import dataclasses
    from repro.configs import SHAPES, get_config
    from repro.models.model_zoo import build_model as jx_build
    from repro_torch.models.model_zoo import build_model
    shape = SHAPES["decode_32k"]
    jcfg = dataclasses.replace(get_config("qwen3-1.7b"), cache_quant="int8")
    pcfg = dataclasses.replace(PD.configure("qwen3-1.7b"),
                               cache_quant="int8")
    got = build_model(pcfg, device="cpu").cache_specs_struct(
        PT_SHAPES["decode_32k"])
    want = jax.eval_shape(lambda: jx_build(jcfg).init_cache(
        shape.global_batch, shape.seq_len))
    assert {"k_scale", "v_scale"} <= set(got)
    assert _struct(got) == _struct(want)
    assert got["k"].dtype.itemsize == 1 and got["k"].device.type == "meta"


@pytest.mark.parametrize("arch,shape,mesh", CELLS,
                         ids=lambda v: str(v))
def test_plan_and_bytes_per_device_equal_the_references(arch, shape, mesh):
    lay = PD.layout_cell(arch, shape, mesh)
    if isinstance(lay, dict):
        assert lay["status"] == "skipped(full-attention)"
        assert shape == "long_500k"
        assert not pt_get_config(arch).is_subquadratic
        return
    want = _reference_layout(arch, shape, mesh)
    got = {k: lay.result[k] for k in FIELDS if k in lay.result}
    assert got == want
    if shape == "train_4k":
        res = lay.result
        assert 1 <= res["microbatch_traced"] <= res["microbatch"]
        assert (PT_SHAPES[shape].global_batch // res["dp"]) % \
            res["microbatch_traced"] == 0


def test_the_ports_own_architectures_have_no_cell():
    """The dry-run prices the JAX package's architectures; one of the port
    alone is named as skipped, with the reason, and has no cell."""
    from repro_torch.configs import PORT_ONLY, list_archs
    assert set(list_archs()) == set(ARCHS) | set(PORT_ONLY)
    assert {a for a, _, _ in CELLS} == set(ARCHS)
    for arch in PORT_ONLY:
        with pytest.raises(NotImplementedError, match="port's alone"):
            PD.configure(arch)
