"""PyTorch port, sharding: ``sharding/rules.py`` against the reference's
rules (first-wins dedup, fitting, the MoE modes, every parameter leaf of
every configuration under every shape kind on both production meshes), its
DTensor placements and constraints on a one-rank gloo group, and the
dry run's op walker (``launch/op_cost.py``): a Python loop of matmuls,
slice-sized writes and collective bytes on a fake group."""
import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.configs.registry import get_config as jget_config
from repro.launch import steps as jsteps
from repro.models.model import model_specs as jmodel_specs
from repro.models.param import logical_axes as jlogical_axes
from repro.sharding import rules as jrules
from repro_torch.configs.base import SHAPES, RunConfig
from repro_torch.configs.registry import all_archs, get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import op_cost
from repro_torch.launch import steps as tsteps
from repro_torch.models.params import model_specs
from repro_torch.sharding import rules as trules

torch.set_num_threads(1)


class FakeMesh:
    """Axis sizes only, as ``tests/test_sharding.py`` fakes a mesh."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"single": FakeMesh(data=16, model=16), "multi": FakeMesh(pod=2, data=16, model=16)}


def test_resolve_first_wins_dedup():
    rules = {"a": "model", "b": "model", "c": ("data", "model")}
    assert trules.resolve_pspec(("a", "b", "c"), rules) == ("model", None, "data")
    assert tuple(jrules.resolve_pspec(("a", "b", "c"), rules)) == ("model", None, "data")


def test_resolve_none_axes():
    assert trules.resolve_pspec((None, "a", "missing"), {"a": "data"}) == (None, "data", None)


@pytest.mark.parametrize("spec,shape,mesh,want", [
    (("model", "data"), (12, 8), FakeMesh(model=16, data=4), (None, "data")),
    ((("pod", "data", "model"),), (64,), FakeMesh(pod=2, data=16, model=16),
     (("pod", "data"),)),
    ((("pod", "data"), None), (3, 5), FakeMesh(pod=2, data=16), (None, None)),
])
def test_fit_matches_reference(spec, shape, mesh, want):
    assert trules.fit_pspec_to_shape(spec, shape, mesh) == want
    assert tuple(jrules.fit_pspec_to_shape(P(*spec), shape, mesh)) == want


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("moe", ["ep", "tp", "auto"])
def test_base_rules_match_reference(multi_pod, kind, moe):
    assert trules.base_rules(multi_pod=multi_pod, shape_kind=kind, moe_sharding=moe) == \
        jrules.base_rules(multi_pod=multi_pod, shape_kind=kind, moe_sharding=moe)


def test_base_rules_moe_modes():
    tp = trules.base_rules(multi_pod=False, shape_kind="train", moe_sharding="tp")
    assert tp["experts"] is None and tp["expert_mlp"] == "model"
    ep = trules.base_rules(multi_pod=False, shape_kind="train", moe_sharding="ep")
    assert ep["experts"] == "model"
    auto = trules.base_rules(multi_pod=True, shape_kind="train", moe_sharding="auto")
    assert auto["experts"] == "pod" and auto["act_batch"] == "data"


def _leaf_axes_and_shapes(tree):
    is_axes = lambda x: isinstance(x, tuple) and all(e is None or isinstance(e, str) for e in x)
    return jax.tree_util.tree_flatten_with_path(jlogical_axes(tree), is_leaf=is_axes)[0]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list(all_archs()))
def test_every_parameter_leaf_resolves_as_the_reference(arch, shape, mesh):
    """``build_rules`` -> ``resolve_pspec`` -> ``fit_pspec_to_shape`` for every
    parameter leaf, with no tolerance: the same spec as the reference's."""
    fm, run = MESHES[mesh], RunConfig(seq_shard_activations=True)
    cfg, cfg_j = get_config(arch), jget_config(arch)
    from repro.configs.base import RunConfig as JRun, SHAPES as JSHAPES
    rules = tsteps.build_rules(cfg, SHAPES[shape], fm, run)
    rules_j = jsteps.build_rules(cfg_j, JSHAPES[shape], fm, JRun(seq_shard_activations=True))
    assert rules == rules_j
    ref = dict(_leaf_axes_and_shapes(jmodel_specs(cfg_j)))
    shapes_j = {jax.tree_util.keystr(k): s.shape for k, s in
                jax.tree_util.tree_flatten_with_path(
                    jmodel_specs(cfg_j), is_leaf=lambda x: hasattr(x, "axes"))[0]}
    got = {path: trules.fit_pspec_to_shape(trules.resolve_pspec(s.axes, rules), s.shape, fm)
           for path, s in _paths(model_specs(cfg)).items()}
    want = {jax.tree_util.keystr(k): tuple(jrules.fit_pspec_to_shape(
        jrules.resolve_pspec(a, rules_j), shapes_j[jax.tree_util.keystr(k)], fm))
        for k, a in ref.items()}
    assert got == want


def _paths(tree, pre=""):
    """{jax keystr path: Spec} of the port's spec tree."""
    if hasattr(tree, "axes"):
        return {pre: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_paths(v, pre + (f"['{k}']" if isinstance(k, str) else f"[{k}]")))
    return out


def test_dispatch_grid_resolution():
    fm = FakeMesh(pod=2, data=16, model=16)
    assert tsteps.dispatch_grid(fm, {"act_batch": ("pod", "data"), "act_seq": "model"}) \
        == (32, 16)
    assert tsteps.dispatch_grid(fm, {"act_batch": None, "act_seq": None}) == (1, 1)


def test_logical_constraint_identity_outside_context():
    x = torch.ones(4, 4)
    assert trules.logical_constraint(x, ("act_batch", "act_seq")) is x
    with trules.sharding_context(None, {"act_batch": "data"}):
        assert trules.logical_constraint(x, ("act_batch", "act_seq")) is x


@pytest.fixture
def one_rank():
    with tmesh.process_group("cpu"):
        yield tmesh.make_mesh((1, 1), ("data", "model"), "cpu")


def test_placements_and_constraint_on_one_rank(one_rank):
    """A one-way mesh dimension replicates; a constraint redistributes a
    DTensor and leaves a plain tensor as it is inside a context."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    mesh = one_rank
    assert trules.placements(("data", None), mesh) == (Replicate(), Replicate())
    x = torch.arange(12.0).reshape(3, 4)
    with trules.sharding_context(mesh, {"act_batch": "data"}):
        assert trules.logical_constraint(x, ("act_batch", None)) is x
        d = trules.logical_constraint(distribute_tensor(x, mesh, [Replicate(), Replicate()]),
                                      ("act_batch", None))
        assert torch.equal(d.full_tensor(), x)


def test_placements_order_over_two_mesh_dims():
    from torch.distributed.tensor import Shard

    class M:
        mesh_dim_names = ("pod", "data", "model")

        def size(self, i):
            return (2, 16, 16)[i]

    assert trules.placements((("pod", "data"), None), M()) == (Shard(0), Shard(0), trules_rep())
    with pytest.raises(ValueError):
        trules.placements((("data", "pod"),), M())


def trules_rep():
    from torch.distributed.tensor import Replicate
    return Replicate()


# ---------------------------------------------------------------------------
# the op walker
# ---------------------------------------------------------------------------

def test_walker_counts_a_python_loop_of_matmuls():
    """Five matmuls in a Python loop: 5 x 2·64³ FLOPs, as the reference's walker
    counts a scan of five; the matmul family against ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode
    x, w = torch.randn(64, 64), torch.randn(5, 64, 64)
    mode, fc = op_cost.OpCostMode(), FlopCounterMode(display=False)
    with mode, fc:
        for i in range(5):
            x = torch.tanh(x @ w[i])
    mm = sum(s.flops for s in mode.top_sites(50) if s.op == "mm")
    assert mm == 5 * 2 * 64 ** 3 == fc.get_total_flops()
    assert mode.cost.flops == mm + 5 * 64 * 64          # tanh: one a result element
    assert any(s.count == 5 and s.op == "mm" for s in mode.top_sites())


def test_walker_slice_write_bytes_are_slice_sized():
    cache = torch.zeros(4096, 128)
    x = torch.ones(1, 128)
    idx = torch.tensor([7])
    mode = op_cost.OpCostMode()
    with mode:
        cache[idx] = x
        cache[9:10].copy_(x)
    assert mode.cost.bytes < 4096 * 128 * 4 * 0.01
    assert mode.cost.peak_bytes < 4096 * 128 * 4 * 0.01        # in place: no new cache


def test_walker_memory_follows_live_storages():
    mode = op_cost.OpCostMode()
    with mode:
        a = torch.ones(1024)             # 4 KiB
        b = a * 2                        # 8 KiB live
        del a
        c = b + 1                        # 8 KiB live again
        b.add_(c)                        # in place: nothing new
        del b, c
    assert mode.cost.peak_bytes == 2 * 4096
    assert mode.cost.live_bytes == 0


def test_walker_counts_collective_bytes_on_a_fake_group():
    """DTensor's collectives on a fake 4-rank group: an all-gather of a
    (16, 8) float32 tensor sharded 4 ways moves its 128-byte shard, an
    all-reduce of a partial (8,) float32 sum its 32 bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor
    from torch.distributed.tensor import DTensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(16, 8), mesh, [Shard(0)])
            p = DTensor.from_local(torch.empty(8), mesh, [Partial()], run_check=False)
            mode = op_cost.OpCostMode()
            with mode:
                x.redistribute(mesh, [Replicate()])
                p.redistribute(mesh, [Replicate()])
        assert mode.cost.collective["all-gather"] == 4 * 8 * 4
        assert mode.cost.collective["all-reduce"] == 8 * 4
    finally:
        dist.destroy_process_group()
