"""The port's parameter placement rules (`parallel/mesh.py`) against the
JAX package's `spec_for_path` and per-dimension guard.

Every parameter of the port is filled with its element ids and carried to
the JAX leaves through `utils/transplant.py`; for each device of a JAX mesh
the ids its shard of each leaf holds (`devices_indices_map` of
`param_shardings`) must be the ids the port's rank of the same index holds
(`shard_tensor` of `placement_for`).  The projection and decoder weights
are the deliberate exceptions (`KEPT_WHOLE_ON_MODEL`): they must match the
JAX placement with its 'model' axis taken out.  No process group is needed.
"""

import re

import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from av_separation_tpu.config import MeshConfig as JaxMeshConfig
from av_separation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from av_separation_tpu.parallel.mesh import param_shardings
from av_separation_torch.config import MeshConfig, ModelConfig
from av_separation_torch.models.model import build_model
from av_separation_torch.parallel import mesh as pm
from av_separation_torch.utils.transplant import _jax_leaves

MESHES = [dict(data=1, fsdp=2, seq=1, model=4),
          dict(data=2, fsdp=1, seq=1, model=4)]
# conv1's C_in 257 and, with 3 speakers, fc2's F*S 771 are odd: the guard
# drops 'fsdp' on them and keeps the other dims' axes.
MODELS = [ModelConfig(freq_bins=257, d_model=64, nhead=4,
                      num_encoder_layers=1, num_fusion_layers=1,
                      num_speakers=n) for n in (2, 3)]


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _exception(name):
    return any(re.fullmatch(p, name) for p in pm.KEPT_WHOLE_ON_MODEL)


@pytest.mark.parametrize("mesh_axes", MESHES, ids=lambda m: "x".join(
    str(v) for v in m.values()))
@pytest.mark.parametrize("model_cfg", MODELS, ids=["S2", "S3"])
def test_every_parameter_lands_where_jax_puts_it(mesh_axes, model_cfg):
    cfg = MeshConfig(**mesh_axes)
    jmesh = jax_make_mesh(JaxMeshConfig(**mesh_axes))
    sizes = dict(mesh_axes)
    params = dict(build_model(model_cfg, device="cpu").named_parameters())
    # Each port tensor as its element ids, and the JAX leaves they become.
    ids = {n: np.arange(p.numel(), dtype=np.float64).reshape(p.shape)
           for n, p in params.items()}
    leaves = {n: list(_jax_leaves(n, a)) for n, a in ids.items()}
    tree = {}
    for per_name in leaves.values():
        for coll, path, value in per_name:
            node = tree.setdefault(coll, {})
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = value
    shardings = param_shardings(jmesh, tree["params"])
    devices = list(jmesh.devices.flat)
    checked = 0
    for name, p in params.items():
        placement = pm.placement_for(name, p.shape, sizes)
        for coll, path, leaf in leaves[name]:
            sharding = _get(shardings, path)
            if _exception(name):
                sharding = NamedSharding(jmesh, P(*(
                    None if a == "model" else a for a in sharding.spec)))
            where = sharding.devices_indices_map(leaf.shape)
            for r, dev in enumerate(devices):
                at = dict(zip(pm.AXES, np.unravel_index(
                    r, (cfg.data, cfg.fsdp, cfg.seq, cfg.model))))
                ours = pm.shard_tensor(torch.from_numpy(ids[name]),
                                       placement, sizes, at).numpy()
                theirs = leaf[where[dev]]
                got = np.intersect1d(ours.ravel(), leaf.ravel())
                assert np.array_equal(np.sort(got),
                                      np.sort(theirs.ravel())), (name, r)
            checked += 1
    assert checked == sum(len(v) for v in leaves.values())


def test_the_exceptions_are_the_projection_and_the_decoder():
    names = [n for n, _ in build_model(MODELS[0], device="cpu")
             .named_parameters() if _exception(n)]
    assert names == ["audio_encoder.input_proj.0.weight",
                     "audio_encoder.input_proj.0.bias",
                     "audio_encoder.input_proj.2.weight",
                     "audio_encoder.input_proj.2.bias",
                     "decoder.decoder.0.weight", "decoder.decoder.0.bias",
                     "decoder.decoder.3.weight"]


@pytest.mark.parametrize("name,shape,want", [
    # q, k and v are split each on its own: every rank holds whole heads
    # of all three.
    ("fusion.layers.0.cross_attn.in_proj_weight", (192, 64),
     pm.Placement(model_dim=0, fsdp_dim=1, blocks=3)),
    ("audio_encoder.input_proj.0.weight", (64, 257, 3),
     pm.Placement(fsdp_dim=None)),
    ("audio_encoder.input_proj.2.weight", (64, 64, 3),
     pm.Placement(fsdp_dim=1)),
    ("visual_encoder.frame_proj.weight", (64, 128), pm.Placement()),
])
def test_placements_and_the_guard(name, shape, want):
    assert pm.placement_for(name, shape, dict(data=1, fsdp=2, seq=1,
                                              model=4)) == want


def test_in_proj_rows_of_a_model_rank_are_whole_heads_of_q_k_v():
    w = torch.arange(12 * 2).reshape(12, 2)  # d 4: q rows 0-3, k 4-7, v 8-11
    piece = pm.shard_tensor(w, pm.Placement(model_dim=0, blocks=3),
                            dict(model=2, fsdp=1), dict(model=1, fsdp=0))
    assert piece[:, 0].tolist() == [4, 6, 12, 14, 20, 22]


def test_split_rows_block_is_d_times_f_plus_f():
    class FakeMesh:
        mesh_dim_names = pm.AXES

        def size(self, i):
            return (2, 2, 1, 1)[i]

        def get_coordinate(self):
            return [1, 0, 0, 0]

    assert pm.split_rows(8, FakeMesh()) == slice(4, 6)
    with pytest.raises(ValueError, match="'data', 'fsdp'"):
        pm.split_rows(6, FakeMesh())


@pytest.mark.parametrize("rows", [1, 2, 3, 4, 8])
def test_separator_buckets_round_up_to_the_batch_ranks_as_in_jax(rows):
    from av_separation_tpu.inference import Separator as JaxSeparator
    from av_separation_torch.inference import Separator

    ours, theirs = object.__new__(Separator), object.__new__(JaxSeparator)
    ours._rows, theirs._data_sz = rows, rows
    for b in (1, 2, 3, 5, 7, 8, 9, 100, 300):
        assert ours._bucket(b) == theirs._bucket(b), b
        assert ours._bucket(b) % rows == 0
