"""The port's cell tables against the reference's, for all 13 configs at
full size and the 4 shapes: ``launch/specs.py`` (``input_specs``,
``cache_specs`` path by path, ``decode_cache_len``, ``cell_is_runnable``,
``SHAPES``, ``LONG_CONTEXT_OK``), ``auto_microbatches`` on one device,
(4, 1), (1, 4) and the production meshes (16, 16) and (2, 16, 16), and
``build_train_step``'s ``args`` (params, opt_state, batch) in shape and
dtype.  Nothing is allocated: the reference's side is
``jax.eval_shape``, the port's the meta device."""
import types

import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.launch.specs as jspecs
import repro_torch.configs as TC
import repro_torch.launch.specs as tspecs
from repro.launch.mesh import make_mesh as j_make_mesh
from repro.launch.steps import auto_microbatches as j_auto_microbatches
from repro.launch.steps import build_train_step as j_build_train_step
from repro_torch.launch.mesh import Mesh, describe, make_production_mesh
from repro_torch.launch.steps import auto_microbatches, build_train_step
from repro_torch.tree import tree_flatten_with_path

SHAPE_NAMES = list(jspecs.SHAPES)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def j_struct(tree):
    """{keystr path: (shape, dtype name)} of a reference tree."""
    return {jax.tree_util.keystr(p): (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def t_struct(tree):
    """The same of a port tree, every leaf on the meta device."""
    flat = tree_flatten_with_path(tree)
    assert all(x.is_meta for _, x in flat)
    return {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in flat}


def test_tables_are_the_reference_tables():
    assert tspecs.SHAPES == jspecs.SHAPES
    assert tspecs.LONG_CONTEXT_OK == jspecs.LONG_CONTEXT_OK


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_specs_match_reference(arch):
    """Every shape: the step inputs, the decode cache (int8 KV and f32),
    its length and whether the cell runs."""
    jcfg, cfg = JC.get_config(arch), TC.get_config(arch)
    for shape in SHAPE_NAMES:
        assert tspecs.cell_is_runnable(cfg, shape) == \
            jspecs.cell_is_runnable(jcfg, shape), shape
        assert tspecs.decode_cache_len(cfg, shape) == \
            jspecs.decode_cache_len(jcfg, shape), shape
        assert t_struct(tspecs.input_specs(cfg, shape)) == \
            j_struct(jspecs.input_specs(jcfg, shape)), shape
        for quant_kv in (True, False):
            assert t_struct(tspecs.cache_specs(cfg, shape, quant_kv)) == \
                j_struct(jspecs.cache_specs(jcfg, shape, quant_kv)), \
                (shape, quant_kv)


def stand_in(axes, shape):
    """What the reference's ``auto_microbatches`` reads of a mesh:
    ``axis_names`` and ``devices.shape`` (its production mesh needs 256
    JAX devices)."""
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, dtype=object))


def port_mesh(axes, shape):
    return Mesh(axis_names=axes, shape=shape,
                ranks=np.arange(int(np.prod(shape))).reshape(shape),
                groups={}, rank=0)


MESHES = {
    "one": (None, stand_in(("data", "model"), (1, 1))),
    "4x1": (port_mesh(("data", "model"), (4, 1)),
            stand_in(("data", "model"), (4, 1))),
    "1x4": (port_mesh(("data", "model"), (1, 4)),
            stand_in(("data", "model"), (1, 4))),
    "pod": (make_production_mesh(), stand_in(("data", "model"), (16, 16))),
    "two_pods": (make_production_mesh(multi_pod=True),
                 stand_in(("pod", "data", "model"), (2, 16, 16))),
}


def test_production_mesh_describes_the_pod():
    pod, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (pod.axis_names, pod.shape, pod.size) == (
        ("data", "model"), (16, 16), 256)
    assert (two.axis_names, two.shape, two.size) == (
        ("pod", "data", "model"), (2, 16, 16), 512)
    assert two.axis_size("pod") == 2 and pod.axis_size("pod") == 1
    assert describe(two) == ("mesh {'pod': 2, 'data': 16, 'model': 16} on "
                             "512 devices (a description: no ranks)")
    with pytest.raises(ValueError, match="no ranks"):
        build_train_step(TC.get_smoke("tinymistral_248m"), pod,
                         device="cpu")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_auto_microbatches_match_reference(mesh):
    ours, theirs = MESHES[mesh]
    for arch in TC.ARCHS:
        jcfg, cfg = JC.get_config(arch), TC.get_config(arch)
        for shape in SHAPE_NAMES:
            assert auto_microbatches(cfg, ours, shape) == \
                j_auto_microbatches(jcfg, theirs, shape), (arch, shape)


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_built_step_args_match_reference(arch):
    """``BuiltStep.args`` at every default (train_4k): the whole parameter
    tree, AdamW's state and the batch, path by path."""
    jcfg, cfg = JC.get_config(arch), TC.get_config(arch)
    mesh = j_make_mesh((1, 1), ("data", "model"))
    want = j_build_train_step(jcfg, mesh).args
    built = build_train_step(cfg, None, device="cpu")
    assert t_struct(built.args) == j_struct(want)
    assert built.meta["microbatches"] == j_auto_microbatches(
        jcfg, mesh, "train_4k")
