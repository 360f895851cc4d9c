"""The decode state's sharding specs (``training.serve.decode_state_specs``,
``batch_axes``) against the reference's, in pure Python.

For all eleven ``--arch`` ids at SMOKE width, the port's decode state
(``Model.init_decode_state``) at batch 32, 2 and 1 and a 64-slot context,
on stand-in meshes of the production shapes (16, 16) and (2, 16, 16), a
(4, 2) and a small (2, 2, 2) one, and without a mesh: every leaf's spec
equals the reference's ``decode_state_specs`` of JAX's decode state of the
same shapes, key by key. The reference's spec logic reads only a mesh's
``axis_names`` and ``shape``, so a ``launch.mesh.Mesh`` layout serves
both. Checked along the way: the k/v caches split by slot over "model"
(not by heads), RWKV-6's state by heads, a batch the batch axes do not
divide falls back to "data" alone or stays whole.
"""

import jax
import pytest

from repro.configs import registry as jregistry
from repro.models import build_model as jbuild
from repro.training import serve as jserve
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.training.serve import batch_axes, decode_state_specs

MESHES = {
    "none": None,
    "4x2": Mesh(("data", "model"), (4, 2)),
    "16x16": Mesh(("data", "model"), (16, 16)),
    "2x16x16": Mesh(("pod", "data", "model"), (2, 16, 16)),
    "2x2x2": Mesh(("pod", "data", "model"), (2, 2, 2)),
}
BATCHES = (32, 2, 1)
SLOTS = 64


def _ref_specs(arch: str, batch: int) -> dict:
    jmodel = jbuild(jregistry.smoke(arch))
    shapes = jax.eval_shape(lambda: jmodel.init_decode_state(batch, SLOTS))
    out = {}
    for name, mesh in MESHES.items():
        specs = jserve.decode_state_specs(shapes, mesh)
        out[name] = {jax.tree_util.keystr(p): tuple(v) for p, v in
                     jax.tree_util.tree_flatten_with_path(
                         specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    return out


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("arch", registry.ARCHS)
def test_decode_state_specs_match_reference(arch, batch):
    state = build_model(registry.smoke(arch)).init_decode_state(batch, SLOTS, device="cpu")
    want = _ref_specs(arch, batch)
    for name, mesh in MESHES.items():
        got = dict(tree.flatten_with_path(decode_state_specs(state, mesh)))
        assert got == want[name], (arch, batch, name)
        for path, spec in got.items():
            key = path.rsplit("'", 2)[-2] if "'" in path else path
            if key in ("k", "v") and mesh is not None and mesh.shape["model"] > 1:
                assert spec[-3] == "model" and spec[-2] is None, (path, spec)  # by slot
            if key == "s" and mesh is not None and mesh.shape["model"] == 2:
                assert spec[-3] == "model", (path, spec)  # RWKV-6's heads
            if key in ("k", "v") and mesh is not None and batch == 1:
                assert spec[-4] is None, (path, spec)  # one sequence stays whole


@pytest.mark.parametrize("name", list(MESHES))
def test_batch_axes_match_reference(name):
    assert batch_axes(MESHES[name]) == jserve.batch_axes(MESHES[name])
