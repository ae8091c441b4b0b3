"""``remat="selective"`` in the traced train step, on the CPU at the reduced
size, on meta tensors (the unit of work and the dry-run price traced steps).

- The backward recomputes no weight product: the traced gradient holds as
  many ``mm``/``addmm`` nodes (and ``bmm`` over a batch of one) as with no
  remat, and as many batched products (attention's, the experts') as with
  full remat, more than with none.
- The train step's matmul FLOPs equal the reference's jaxpr's for the same
  setting on every family (for the SSM families after the measured gap of
  `test_torch_dryrun_trace._ssd_backward_gap`, as there), and exceed those
  with no remat.
"""
import dataclasses

import pytest
import torch

from repro_torch.models import layers as L
from repro_torch.models.model_zoo import build_model

IMPLS = dict(attention_impl="chunked", ssm_impl="chunked")


def _traced_products(pcfg):
    """Counts of the weight products and of the batched products in the
    ATen graph of the loss's gradient, on meta tensors."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.unit_of_work import op_name, trace_graph
    from repro_torch.launch.dryrun import _spec_struct
    m = build_model(pcfg, device="meta")
    params = _spec_struct(m.specs(), torch.float32)
    batch = m.input_specs(ShapeConfig("x", "train", 32, 2))
    leaves = L.tree_leaves(params)

    def grads(ps, b):
        with torch.enable_grad():
            for t in L.tree_leaves(ps):
                t.requires_grad_(True)
            return torch.autograd.grad(m.loss(ps, b)[0], L.tree_leaves(ps))
    g = trace_graph(grads, params, batch)
    counts = {"weight": 0, "batched": 0}
    for n in g.graph.nodes:
        if n.op != "call_function":
            continue
        name = op_name(n)
        if name in ("mm", "addmm"):
            counts["weight"] += 1
        elif name in ("bmm", "baddbmm"):
            lhs = n.args[0 if name == "bmm" else 1].meta["val"]
            counts["weight" if lhs.shape[0] == 1 else "batched"] += 1
    assert leaves
    return counts


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b"])
def test_backward_recomputes_no_weight_product(arch):
    from repro_torch.configs import get_config, reduced
    base = dataclasses.replace(reduced(get_config(arch)), attn_chunk=8,
                               **IMPLS)
    c = {r: _traced_products(dataclasses.replace(base, remat=r))
         for r in ("none", "full", "selective")}
    assert c["selective"]["weight"] == c["none"]["weight"] > 0
    assert c["full"]["weight"] > c["none"]["weight"]
    assert c["selective"]["batched"] == c["full"]["batched"] > \
        c["none"]["batched"]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b", "mamba2-780m",
                                  "zamba2-1.2b"])
def test_selective_step_matmul_flops_equal_the_references(arch):
    import test_torch_dryrun_trace as DT
    jcfg, pcfg = DT._configs(arch, "selective")
    want = DT._jax_step_flops(jcfg, "train", 4)
    step, state, inputs = DT._port_step(pcfg, "train", 4)
    got = DT._port_train_parts(step, state, inputs, 1, DT._recorded_matmul)
    if pcfg.family in ("ssm", "hybrid"):
        got += pcfg.n_layers * DT._ssd_backward_gap(pcfg, 4)
    full_jcfg, _ = DT._configs(arch, "none")
    assert got == want > DT._jax_step_flops(full_jcfg, "train", 4)
