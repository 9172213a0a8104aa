"""The port's sharding functions held against the reference's on the CPU,
with no process group: the rules (``attn_mode``, ``make_rules``,
``cnn_serve_rules``, ``data_pspec``), the input shapes (``SHAPES``,
``cell_runnable``, ``input_specs``) and, for every registry config at its
full published size, the parameter, cache and compressed trees and their
partition specs (``LM.abstract``, ``pspecs``, ``cache_abstract``,
``cache_pspecs``, ``compressed_abstract``, ``compressed_pspecs``).

The port's trees are ``meta`` tensors (nothing is allocated: a full-size
deepseek-v3 would be 1.3 TB) and its specs tuples, one entry per dim, each
None, a mesh axis name or a tuple of names; each is equal to the
reference's ``ShapeDtypeStruct`` and ``PartitionSpec`` at the same place,
leaf by leaf. :func:`spec_placements`' DTensor placements are checked on a
fake mesh object that has only names and sizes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as jget_config
from repro.configs import shapes as jshapes
from repro.core.vdbb import DBBWeight as JDBBWeight
from repro.models.model import LM as JLM
from repro.sharding import rules as jrules
from repro_torch.configs import get_config, shapes
from repro_torch.configs.registry import ARCHS
from repro_torch.core.vdbb import DBBWeight
from repro_torch.models.common import spec_placements
from repro_torch.models.model import LM
from repro_torch.sharding import rules

NAMES = sorted(ARCHS)
TPS = (1, 2, 4, 8, 16)
MODES = ("train", "prefill", "decode")


def test_every_registry_config_is_covered():
    from repro.configs.registry import ARCHS as JARCHS

    assert sorted(JARCHS) == NAMES and len(NAMES) == 11


# ------------------------------------------------------------------ rules

@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("name", NAMES)
def test_rules_match_the_reference(name, tp, mode, multi_pod):
    cfg, jcfg = get_config(name), jget_config(name)
    assert rules.attn_mode(cfg, tp) == jrules.attn_mode(jcfg, tp)
    got = rules.make_rules(cfg, tp=tp, multi_pod=multi_pod, mode=mode)
    assert got == jrules.make_rules(jcfg, tp=tp, multi_pod=multi_pod, mode=mode)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_cnn_serve_rules_and_data_pspec_match(multi_pod):
    r = rules.cnn_serve_rules(multi_pod=multi_pod)
    jr = jrules.cnn_serve_rules(multi_pod=multi_pod)
    assert r == jr
    assert _same_spec(rules.data_pspec(r), jrules.data_pspec(jr))
    lm = rules.make_rules(get_config("qwen2-72b"), multi_pod=multi_pod)
    assert _same_spec(rules.data_pspec(lm), jrules.data_pspec(lm))


# ----------------------------------------------------------------- shapes

def test_shapes_match():
    assert shapes.SHAPES == jshapes.SHAPES


@pytest.mark.parametrize("shape", sorted(jshapes.SHAPES))
@pytest.mark.parametrize("name", NAMES)
def test_cell_runnable_matches(name, shape):
    assert shapes.cell_runnable(get_config(name), shape) == \
        jshapes.cell_runnable(jget_config(name), shape)


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


RUNNABLE = [(n, s) for n in NAMES for s in sorted(jshapes.SHAPES)
            if jshapes.cell_runnable(jget_config(n), s)[0]]


@pytest.mark.parametrize("name,shape", RUNNABLE)
def test_input_specs_match(name, shape):
    got = shapes.input_specs(get_config(name), shape)
    want = jshapes.input_specs(jget_config(name), shape)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert _dtype(got[k]) == jnp.dtype(w.dtype).name, k


# ------------------------------------------------ trees and specs, full size

def _walk(tree, path=()):
    """(path, leaf) in key order; a compressed weight gives its values and
    indices, a reference spec (a tuple subclass) is a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, (DBBWeight, JDBBWeight)):
        yield path + ("values",), tree.values
        yield path + ("indices",), tree.indices
    else:
        yield path, tree


def _same_leaves(got, want, same):
    g, w = list(_walk(got)), list(_walk(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert same(a, b), (path, a, b)
    return len(g)


def _same_abstract(a, b) -> bool:
    return a.device.type == "meta" and tuple(a.shape) == tuple(b.shape) and \
        _dtype(a) == jnp.dtype(b.dtype).name


def _entries(spec) -> tuple:
    """A spec's entries as ``PartitionSpec`` reads them: a one-name tuple
    is that name (jax normalises ``P(("data",))`` to ``P("data")``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _same_spec(a, b) -> bool:
    return isinstance(a, tuple) and not isinstance(a, P) and _entries(a) == _entries(tuple(b))


def _models(name):
    return LM(get_config(name)), JLM(jget_config(name))


@pytest.mark.parametrize("name", NAMES)
def test_abstract_params_match_at_full_size(name):
    m, jm = _models(name)
    assert _same_leaves(m.abstract(), jm.abstract(), _same_abstract) > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_param_pspecs_match(name, mode):
    m, jm = _models(name)
    r = rules.make_rules(m.cfg, tp=16, mode=mode)
    _same_leaves(m.pspecs(r), jm.pspecs(r), _same_spec)


@pytest.mark.parametrize("name", NAMES)
def test_cache_abstract_and_pspecs_match(name):
    m, jm = _models(name)
    _same_leaves(m.cache_abstract(128, 32768), jm.cache_abstract(128, 32768), _same_abstract)
    r = rules.make_rules(m.cfg, tp=16, mode="decode")
    _same_leaves(m.cache_pspecs(r), jm.cache_pspecs(r), _same_spec)


@pytest.mark.parametrize("name", NAMES)
def test_compressed_abstract_matches_at_full_size(name):
    m, jm = _models(name)
    _same_leaves(m.compressed_abstract(), jm.compressed_abstract(), _same_abstract)


@pytest.mark.parametrize("name", NAMES)
def test_compressed_pspecs_match(name):
    m, jm = _models(name)
    r = rules.make_rules(m.cfg, tp=16, mode="decode")
    got, want = m.compressed_pspecs(r), jm.compressed_pspecs(r)
    _same_leaves(got, want, _same_spec)

    def formats(tree):  # the formats and dense shapes too
        return [(p, x.fmt.bz, x.fmt.nnz, x.fmt.group, tuple(x.shape))
                for p, x in _walk_weights(tree)]

    assert formats(got) == formats(want)


def _walk_weights(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk_weights(tree[k], path + (k,))
    elif isinstance(tree, (DBBWeight, JDBBWeight)):
        yield path, tree


# ------------------------------------------------------ specs -> placements

@dataclasses.dataclass
class FakeMesh:
    """What spec_placements reads of a DeviceMesh: names and sizes."""

    mesh_dim_names: tuple
    shape: tuple

    @property
    def ndim(self):
        return len(self.shape)

    def size(self, i):
        return self.shape[i]


POD = FakeMesh(("pod", "data", "model"), (2, 4, 2))


@pytest.mark.parametrize("spec,want", [
    ((None, None), (Replicate(), Replicate(), Replicate())),
    (("model", None), (Replicate(), Replicate(), Shard(0))),
    ((None, "data"), (Replicate(), Shard(1), Replicate())),
    ((("pod", "data"), "model"), (Shard(0), Shard(0), Shard(1))),
    ((("data",), None), (Replicate(), Shard(0), Replicate())),
    ((), (Replicate(), Replicate(), Replicate())),
])
def test_spec_placements(spec, want):
    assert spec_placements(spec, POD, (16, 8)) == want


@pytest.mark.parametrize("spec,shape,match", [
    ((("data", "pod"), None), (16, 8), "order"),  # JAX would shard data-major
    (("model", "model"), (16, 8), "two dims"),
    (("expert", None), (16, 8), "not in the mesh"),
    ((("pod", "data"), None), (12, 8), "does not divide"),
    (("model", None, None), (16, 8), "more entries"),
])
def test_spec_placements_refuses(spec, shape, match):
    with pytest.raises(ValueError, match=match):
        spec_placements(spec, POD, shape)


def test_a_mesh_dim_of_one_rank_replicates():
    one = FakeMesh(("data", "model"), (4, 1))
    assert spec_placements(("data", "model"), one, (8, 8)) == (Shard(0), Replicate())


def test_uneven_dims_stay_replicated_where_asked():
    assert spec_placements(("model", "data"), POD, (1, 8), uneven="replicate") == \
        (Replicate(), Shard(1), Replicate())


def test_meta_trees_allocate_nothing():
    """deepseek-v3 at full size: the abstract tree holds 671 B parameters
    on the meta device, and its compressed tree likewise."""
    m = LM(get_config("deepseek-v3-671b"))
    leaves = [x for _, x in _walk(m.abstract())]
    assert all(x.device.type == "meta" for x in leaves)
    assert sum(x.numel() for x in leaves) > 6e11
    assert all(x.device.type == "meta" for _, x in _walk(m.compressed_abstract()))


def test_jax_tree_paths_agree_with_the_walk():
    """The walk's key order is the reference's flatten order."""
    jm = JLM(jget_config("qwen2-tiny"))
    flat = jax.tree_util.tree_flatten_with_path(jm.abstract())[0]
    assert [tuple(k.key for k in p) for p, _ in flat] == [p for p, _ in _walk(jm.abstract())]
