"""Importing the reference's (turbdiff's) checkpoint into the port:
``toolchain/import_ckpt.py`` and the unpickling of
``scripts/import_checkpoint.py``, against the JAX package's importer.

The reference's sources are not part of the repository, so the
turbdiff-keyed state dicts are synthesised: a seeded port ``DenoisingModel`` written under the
reference's keys by ``to_reference_state_dict``.  The JAX package's own
``map_reference_key`` must map every such key to the name of the leaf it
came from, and its ``convert_state_dict`` must cover every leaf of the flax
model (its ``check_against``).  The same dict then goes through JAX's
converter into the JAX model and through the port's into the port's model,
whose forwards must agree at f32 rtol 2e-4 / atol 2e-5
(``tests/test_pallas_kernels.py:29``).  Variants: group and instance norm,
a cell-type embedding, learned variances (2 levels, dim 8, batch 2 at
12x10x10), and the geometry embedding, whose three VALID 5^3 convs need
45^3 voxels (1 level, batch 1), held to the JAX package's own tolerance
for that path, rtol 5e-4 / atol 5e-5 (``tests/test_ckpt_import.py``): its
spatial means sum 91k voxels.  Where ``_reference_stub`` imports the
reference, its own forward is held to the port's too.
"""

import builtins
import enum
import importlib.util
import os
import sys
import types
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_turbulence_tpu.models.conditioning import Conditioning as JConditioning
from generative_turbulence_tpu.models.unet import DenoisingModel as JDenoisingModel
from generative_turbulence_tpu.toolchain import import_ckpt as jimport
from generative_turbulence_tpu_torch.models.conditioning import Conditioning
from generative_turbulence_tpu_torch.models.unet import DenoisingModel
from generative_turbulence_tpu_torch.scripts import import_checkpoint
from generative_turbulence_tpu_torch.toolchain import import_ckpt as timport

REPO = Path(__file__).resolve().parents[1]
F32_TOL = dict(rtol=2e-4, atol=2e-5)
GEOMETRY_TOL = dict(rtol=5e-4, atol=5e-5)  # tests/test_ckpt_import.py::test_forward_parity_geometry_embedding

# name: (model arguments, (batch, X, Y, Z), cell-type embedding width or None)
VARIANTS = {
    "group": (dict(out_features=4, u_net_levels=2, norm_type="group"), (2, 12, 10, 10), None),
    "instance": (dict(out_features=4, u_net_levels=2, norm_type="instance"), (2, 12, 10, 10), None),
    "cell-type": (dict(out_features=4, u_net_levels=2, norm_type="group"), (2, 12, 10, 10), 4),
    "learned-variances": (dict(out_features=8, u_net_levels=2, norm_type="group"), (2, 12, 10, 10), 4),
    "geometry": (dict(out_features=4, u_net_levels=1, norm_type="group", with_geometry_embedding=True),
                 (1, 45, 45, 45), 3),
}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def port_model(kwargs, emb, seed):
    conditioning = None if emb is None else Conditioning(cell_type_embedding_dim=emb)
    model = DenoisingModel(timesteps=10, dim=8, in_features=4, conditioning=conditioning, **kwargs)
    return model.init_weights(torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module", params=list(VARIANTS))
def imported(request):
    """One variant: the synthesised reference dict, both conversions, and
    both forwards on the same inputs."""
    kwargs, (batch, *grid), emb = VARIANTS[request.param]
    levels = kwargs["u_net_levels"]
    source = port_model(kwargs, emb, seed=0)
    ref_sd = timport.to_reference_state_dict(source.state_dict(), levels)
    ref_sd["model.betas"] = torch.linspace(1e-4, 0.02, 10, dtype=torch.float64)

    rng = np.random.default_rng(1)
    x = rng.normal(size=(batch, *grid, 4)).astype(np.float32)
    t = np.array([3, 7][:batch], dtype=np.int32)
    cell_types = rng.integers(0, 6, size=grid).astype(np.int32)
    jargs = (jnp.asarray(x), jnp.asarray(t)) + ((jnp.asarray(cell_types),) if emb else ())

    jmodel = JDenoisingModel(timesteps=10, dim=8, conditioning=JConditioning(cell_type_embedding_dim=emb) if emb
                             else None, **kwargs)
    jparams, jbuffers = jimport.convert_state_dict({k: v.numpy() for k, v in ref_sd.items()}, levels)
    target = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *jargs)
    jimport.check_against(jparams, target["params"])
    want = np.asarray(jmodel.apply({"params": jax.tree.map(jnp.asarray, jparams)}, *jargs))

    state_dict, buffers = timport.convert_state_dict(ref_sd, levels)
    model = port_model(kwargs, emb, seed=1)
    timport.check_against(state_dict, model)
    model.load_state_dict(state_dict)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long(),
                    torch.from_numpy(cell_types).long() if emb else None).numpy()
    return dict(source=source.state_dict(), ref_sd=ref_sd, levels=levels, state_dict=state_dict, buffers=buffers,
                jbuffers=jbuffers, got=got, want=want,
                tol=GEOMETRY_TOL if kwargs.get("with_geometry_embedding") else F32_TOL)


def test_jax_maps_every_synthesised_key_to_its_leaf(imported):
    """JAX's ``map_reference_key`` takes each reference key back to the
    name of the port leaf it was written from."""
    names = list(imported["source"])
    keys = timport.to_reference_state_dict(imported["source"], imported["levels"])
    assert len(keys) == len(names)
    for key, name in zip(keys, names):
        assert jimport.map_reference_key(key, imported["levels"])[0] == name
        assert timport.map_reference_key(key, imported["levels"])[0] == name


def test_import_is_a_rename(imported):
    """Every tensor reaches the port's state_dict as it was, and the
    schedule buffer lands in the buffers on both sides."""
    state_dict, source = imported["state_dict"], imported["source"]
    assert state_dict.keys() == source.keys()
    for name, value in state_dict.items():
        assert value.dtype == source[name].dtype and torch.equal(value, source[name]), name
    assert set(imported["buffers"]) == set(imported["jbuffers"]) == {"model.betas"}
    np.testing.assert_array_equal(imported["buffers"]["model.betas"].numpy(), imported["jbuffers"]["model.betas"])


def test_forward_matches_jax(imported):
    assert imported["got"].shape == imported["want"].shape
    np.testing.assert_allclose(imported["got"], imported["want"], **imported["tol"])


@pytest.mark.parametrize("key", [
    "model.model.bogus.weight",
    "model.model.u_net.downsampling_blocks.0.bogus.weight",
    "model.model.geometry_embedding.extract_features.1.weight",
    "model.model.u_net.center_block.1.fn.fn.to_kv.weight",
])
def test_unknown_key_raises(key):
    for convert in (jimport.convert_state_dict, timport.convert_state_dict):
        with pytest.raises(KeyError):
            convert({key: np.zeros((3,), np.float32)}, 2)


@pytest.mark.parametrize("key", ["model.betas", "model.alphas_cumprod", "normalization.mean", "val_samples.x"])
def test_buffers_are_kept_aside(key):
    params, buffers = timport.convert_state_dict({key: np.arange(4.0)}, 2)
    assert params == {} and list(buffers) == [key] and buffers[key].dtype == torch.float64


def test_convert_refuses_a_tensor_of_the_wrong_rank():
    with pytest.raises(ValueError, match="rank 2, expected 5"):
        timport.convert_state_dict({"model.model.encode_x.weight": np.zeros((8, 4), np.float32)}, 2)


def test_check_against_reports_every_difference():
    model = port_model(VARIANTS["group"][0], None, seed=0)
    state_dict = dict(model.state_dict())
    del state_dict["decode_out.bias"]
    state_dict["u_net.down_0.extra.weight"] = torch.zeros(3)
    state_dict["encode_x.weight"] = torch.zeros(8, 4, 3, 3, 3)
    with pytest.raises(ValueError) as err:
        timport.check_against(state_dict, model)
    message = str(err.value)
    assert "missing (in checkpoint): decode_out.bias" in message
    assert "unexpected (no model parameter): u_net.down_0.extra.weight" in message
    assert "shape mismatch: encode_x.weight ckpt(8, 4, 3, 3, 3) != model(8, 4, 1, 1, 1)" in message


def _jax_import_script():
    """``scripts/import-checkpoint.py``, loaded by its path."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        spec = importlib.util.spec_from_file_location("jax_import_checkpoint", REPO / "scripts" / "import-checkpoint.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(REPO / "scripts"))
    return module


def test_hparams_to_overrides_matches_jax():
    hparams = {"dim": 32, "timesteps": 500, "beta_schedule": "log-snr-linear", "norm_type": "group",
               "learned_variances": False, "elbo_weight": None, "learning_rate": 1e-4, "clip_denoised": True,
               "cell_type_embedding_dim": 4, "with_geometry_embedding": False, "unknown": 3,
               "variables": (types.SimpleNamespace(name="U"), types.SimpleNamespace(name="P"))}
    jax_script = _jax_import_script()
    assert import_checkpoint.HPARAM_MAP == jax_script.HPARAM_MAP
    got = import_checkpoint.hparams_to_overrides(hparams)
    assert got == jax_script.hparams_to_overrides(hparams)
    assert "model.variables=u,p" in got and not any("elbo_weight" in o or "unknown" in o for o in got)


# ---- unpickling the Lightning checkpoint ----------------------------------------


class _Ofles(enum.Enum):
    """The reference's ``Variable`` enum, as its pickle names it."""

    U = "u"
    P = "p"


def _save_turbdiff_named(obj, path):
    """torch.save ``obj`` with ``_Ofles`` pickled as
    ``turbdiff.data.ofles.Variable`` (a module this process then forgets)."""
    modules = {name: types.ModuleType(name) for name in ("turbdiff", "turbdiff.data", "turbdiff.data.ofles")}
    modules["turbdiff.data.ofles"].Variable = _Ofles
    _Ofles.__module__, _Ofles.__qualname__ = "turbdiff.data.ofles", "Variable"
    try:
        with mock.patch.dict(sys.modules, modules):
            torch.save(obj, path)
    finally:
        _Ofles.__module__, _Ofles.__qualname__ = __name__, "_Ofles"


def test_weights_only_checkpoint_needs_no_trust(tmp_path):
    ckpt = {"state_dict": {"model.betas": torch.arange(3.0)}, "hyper_parameters": {"dim": 8}}
    torch.save(ckpt, tmp_path / "plain.ckpt")
    loaded = import_checkpoint.load_lightning_ckpt(tmp_path / "plain.ckpt")
    assert loaded["hyper_parameters"] == {"dim": 8} and torch.equal(loaded["state_dict"]["model.betas"],
                                                                     torch.arange(3.0))


def test_turbdiff_classes_need_trust_pickle(tmp_path):
    """A pickle naming the reference's classes loads only with
    ``--trust-pickle``, and then without the reference: its ``Variable``
    members come back as stand-ins with their ``name``."""
    ckpt = {"state_dict": {"model.betas": torch.arange(3.0)},
            "hyper_parameters": {"dim": 8, "variables": (_Ofles.U, _Ofles.P)}}
    _save_turbdiff_named(ckpt, tmp_path / "turbdiff.ckpt")
    assert "turbdiff" not in sys.modules
    with pytest.raises(SystemExit, match="--trust-pickle"):
        import_checkpoint.load_lightning_ckpt(tmp_path / "turbdiff.ckpt")
    loaded = import_checkpoint.load_lightning_ckpt(tmp_path / "turbdiff.ckpt", trust_pickle=True)
    variables = loaded["hyper_parameters"]["variables"]
    assert [type(v).__module__ for v in variables] == ["turbdiff.data.ofles"] * 2
    assert import_checkpoint.hparams_to_overrides(loaded["hyper_parameters"]) == ["model.dim=8",
                                                                                  "model.variables=u,p"]
    assert "turbdiff" not in sys.modules


_CALLS = []


def _record_call(*args):
    _CALLS.append(args)


class _Calls:
    """Unpickles by calling ``call(*args)``, as a hostile pickle would."""

    def __init__(self, call, args):
        self.call, self.args = call, args

    def __reduce__(self):
        return self.call, self.args


@pytest.mark.parametrize("call", [_record_call, builtins.eval, os.system], ids=["module-function", "eval", "system"])
def test_trusted_load_runs_no_code_of_the_file(tmp_path, call):
    """With ``--trust-pickle`` a global outside torch's weights_only set
    comes back as an inert stand-in holding its arguments; it is never
    called."""
    marker = tmp_path / "ran"
    args = {_record_call: ("ran",), builtins.eval: (f"open({str(marker)!r}, 'w').close()",),
            os.system: (f"touch {marker}",)}[call]
    ckpt = {"state_dict": {"model.betas": torch.arange(3.0)},
            "hyper_parameters": {"payload": _Calls(call, args), "tags": {"a", "b"}}}
    torch.save(ckpt, tmp_path / "hostile.ckpt")
    with pytest.raises(SystemExit, match="--trust-pickle"):
        import_checkpoint.load_lightning_ckpt(tmp_path / "hostile.ckpt")
    loaded = import_checkpoint.load_lightning_ckpt(tmp_path / "hostile.ckpt", trust_pickle=True)
    payload = loaded["hyper_parameters"]["payload"]
    assert isinstance(payload, import_checkpoint._StandIn) and payload.args == args
    assert type(payload).__name__ == call.__name__
    assert loaded["hyper_parameters"]["tags"] == {"a", "b"}  # a global of the weights_only set resolves
    assert torch.equal(loaded["state_dict"]["model.betas"], torch.arange(3.0))
    assert not marker.exists() and _CALLS == []


def test_unknown_reference_variable_raises():
    """A ``Variable`` value the port does not know is an error that names
    it, not a variable of that name."""
    variable = import_checkpoint._stand_in("turbdiff.data.ofles", "Variable")
    assert variable("nut").name == "NUT"
    with pytest.raises(ValueError, match="'vorticity' is none of the port's"):
        import_checkpoint.hparams_to_overrides({"variables": (variable("u"), variable("vorticity"))})


# ---- the reference's own model, where it imports ----------------------------------


def _reference():
    sys.path.insert(0, str(Path(__file__).parent))
    try:
        from _reference_stub import load_reference_turbdiff

        return load_reference_turbdiff()
    except Exception as e:  # the reference tree is not on every machine
        pytest.skip(f"reference turbdiff package not importable: {e}")
    finally:
        sys.path.remove(str(Path(__file__).parent))


def test_reference_forward_matches_the_port():
    ref_ddpm, _ = _reference()
    torch.manual_seed(0)
    ref = ref_ddpm.DenoisingModel(in_features=4, out_features=4, c_local_features=0, c_global_features=0,
                                  timesteps=10, dim=8, u_net_levels=2, norm_type="group",
                                  with_geometry_embedding=False)
    sd = {f"model.model.{k}": v for k, v in ref.state_dict().items()}
    state_dict, _ = timport.convert_state_dict(sd, 2)
    model = port_model(VARIANTS["group"][0], None, seed=1)
    timport.check_against(state_dict, model)
    model.load_state_dict(state_dict)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 10, 10, 4)).astype(np.float32)
    t = np.array([3, 7])
    with torch.no_grad():
        want = ref(torch.from_numpy(np.moveaxis(x, -1, 1).copy()), torch.from_numpy(t), {}).numpy()
        got = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, np.moveaxis(want, 1, -1), **F32_TOL)
