"""The port's distribution against the JAX package's, as
tests/test_distributed.py holds the reference, and more:

* sharding rules: ``param_specs`` (every leaf of every assigned config at
  ``ep_size=16``), ``cache_specs`` (every family, ``data_only`` on and off
  against the reference's ``decode_cache_data_only``) and
  ``activation_spec`` per kind (``seq_parallel`` on and off) against the
  reference's shard hook equal the reference's on 16 x 16 and 2 x 16 x 16 meshes (the port's
  over the in-process fake process group, the reference's an
  ``AbstractMesh``), and the unsharded specs equal too;
* ``quantize_int8`` bit-equal to the reference's, its round trip within
  ``max|x| / 127``; ``compressed_psum`` in 2 ranks within 5e-5 of the exact
  sum and within 1e-7 of the reference's on a 2-pod mesh, the error buffer
  exactly ``g + e`` less its dequantized int8 (within 1e-9 of the
  reference's, whose subtraction XLA fuses with the product);
* ``moe_ffn_ep`` in 2 ranks on a 1 x 2 mesh within 1e-5 (f32) of the
  reference's on the same mesh at capacity 8.0, 1.0 and 0.5, at S = 8 and
  S = 1, the aux loss within 1e-6 relative; at 8.0 also against
  ``moe_ffn_dense`` (the reference test's 2e-2, and 1e-5) with the
  gradients in x, the router and the expert stacks within 1e-5; a prefill
  and a decode step of the smoke granite-moe with ``dist`` within 1e-5 of
  the reference's logits;
* the optimizers' ``state_specs`` equal the reference's, and three AdamW
  and Adafactor steps on DTensors placed by them (a 2 x 2 mesh, factored
  leaves split across ranks) within 1e-6 of the LOCAL steps;
* elastic restore LOCAL -> 2 x 1, LOCAL -> 2 x 2 and 2 x 2 -> LOCAL, byte
  for byte;
* the sharded train step for the smoke qwen1.5-0.5b and granite-moe on
  meshes (2, 1), (1, 2) and (2, 2) in 4 ranks, 3 steps: step 0's loss and
  ``grad_norm`` within STEP_RTOL (1e-5) of the reference's
  ``make_train_step`` on the same mesh, every step's within CURVE_RTOL
  (1e-4), as tests/test_torch_train.py holds ``LOCAL``;
* ``evaluate`` on the full family grid with ``config_mesh(1)`` and
  ``config_mesh(4)`` (4 ranks) under the NumPy oracle's contract
  (tests/test_whatif_backend.py), and ``search_frontier`` with a mesh
  evaluating the same configs in the same order as without;
* ``make_local_dist(1, 1) is LOCAL`` and ``make_dist``'s meshes.

The reference runs on meshes of Auto axes over the 4 host devices that
tests/conftest.py forces (``jax.make_mesh`` gives Explicit axes in jax 0.9,
on which the reference's EP dispatch and the reference test's indexing
fail). The port's groups are gloo groups of CPU processes, one a test
function, started by ``torch.multiprocessing.spawn`` (tests/_dist_workers.py,
which imports only torch, numpy and the port). The file takes 45 s on a quiet
8-core machine, about twice that under load.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _dist_workers as W
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.compression import dequantize_int8, quantize_int8
from repro_torch.distributed.context import LOCAL, P
from repro_torch.launch.mesh import make_dist, make_local_dist
from repro_torch.models import api
from repro_torch.train.tree import flatten

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, AxisType, Mesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.distributed.compat import shard_map  # noqa: E402
from repro.distributed.context import DistContext as JDist  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import tuning as jtuning  # noqa: E402

STEP_RTOL = 1e-5
CURVE_RTOL = 1e-4
EP_TOL = 1e-5
MOE = "granite-moe-3b-a800m"
#: one assigned config of each family
FAMILY_ARCHS = {"dense": "qwen1.5-0.5b", "moe": MOE, "mla_moe": "deepseek-v3-671b",
                "rwkv": "rwkv6-3b", "hybrid": "hymba-1.5b", "encdec": "whisper-tiny",
                "vlm": "llama-3.2-vision-90b"}


def auto_mesh(shape, names):
    """A reference mesh of Auto axes over the first host devices."""
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names,
                axis_types=(AxisType.Auto,) * len(shape))


def ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in flat]


def port_flat(tree):
    return [(k, tuple(s)) for k, s in flatten(tree)]


# --------------------------------------------------------------------------- #
# sharding rules on the production meshes
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def meshes():
    """(port, reference) contexts: unsharded, 16 x 16 and 2 x 16 x 16; the
    port's over a fake process group of 512 ranks in this process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        yield {
            "local": (LOCAL, JDist()),
            "16x16": (make_dist(), JDist(mesh=AbstractMesh((16, 16), ("data", "model")))),
            "2x16x16": (make_dist(multi_pod=True),
                        JDist(mesh=AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                              batch_axes=("pod", "data"))),
        }
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_match_reference(meshes, arch):
    abstract = api.abstract_params(get_config(arch), ep_size=16)
    ref_abstract = japi.abstract_params(jax_config(arch), ep_size=16)
    n_leaves = len(flatten(abstract))
    for name, (dist, jdist) in meshes.items():
        got = port_flat(shd.param_specs(abstract, dist))
        assert len(got) == n_leaves, name
        assert got == ref_flat(jshd.param_specs(ref_abstract, jdist)), (arch, name)
    # the production mesh shards most of the parameters
    specs = port_flat(shd.param_specs(abstract, meshes["16x16"][0]))
    assert sum(any(e is not None for e in s) for _, s in specs) > n_leaves // 3


@pytest.mark.parametrize("data_only", [False, True], ids=["seq_or_heads", "data_only"])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_cache_specs_match_reference(meshes, family, data_only):
    arch = FAMILY_ARCHS[family]
    cache = api.init_cache(get_config(arch), 32, 256, "meta")
    ref_cache = jax.eval_shape(lambda: japi.init_cache(jax_config(arch), 32, 256))
    try:
        jtuning.set_tuning(decode_cache_data_only=data_only)
        for name, (dist, jdist) in list(meshes.items())[1:]:
            got = port_flat(shd.cache_specs(get_config(arch), cache, dist, data_only=data_only))
            want = ref_flat(jshd.cache_specs(jax_config(arch), ref_cache, jdist))
            assert got == want, (family, name)
    finally:
        jtuning.reset()


@dataclasses.dataclass(frozen=True)
class RefCapture(JDist):
    """The reference's context with its constraint returning the spec."""
    def constraint(self, x, spec):
        return spec


HOOK_SHAPES = {"act_bsd": [(32, 256, 64), (32, 255, 64)], "act_bshd": [(32, 256, 12, 64)],
               "kv_bskd": [(32, 256, 2, 64)], "kv_cache_bskd": [(32, 256, 2, 64)],
               "logits": [(32, 256, 1000)], "other": [(4, 4)]}


@pytest.mark.parametrize("seq_parallel", [False, True], ids=["baseline", "seq_parallel"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_shard_hook_specs_match_reference(meshes, arch, seq_parallel):
    """``activation_spec`` gives each kind and shape the spec that the
    reference's shard hook constrains it to (None where the hook leaves the
    activation as it is)."""
    try:
        jtuning.set_tuning(seq_parallel=seq_parallel)
        for name, (dist, jdist) in list(meshes.items())[1:]:
            ref_hook = jshd.make_shard_hook(jax_config(arch), RefCapture(
                mesh=jdist.mesh, batch_axes=jdist.batch_axes))
            for kind, shapes in HOOK_SHAPES.items():
                for shape in shapes:
                    got = shd.activation_spec(get_config(arch), dist, kind, shape,
                                              seq_parallel=seq_parallel)
                    want = ref_hook(jax.ShapeDtypeStruct(shape, jnp.float32), kind)
                    want = tuple(want) if isinstance(want, JP) else None
                    assert (None if got is None else tuple(got)) == want, (arch, name, kind, shape)
        assert jshd.make_shard_hook(jax_config(arch), JDist()) is None
    finally:
        jtuning.reset()


def test_make_local_dist_and_make_dist(meshes):
    assert make_local_dist(1, 1) is LOCAL
    single, multi = meshes["16x16"][0], meshes["2x16x16"][0]
    assert (single.mesh.shape, single.mesh.mesh_dim_names) == ((16, 16), ("data", "model"))
    assert (single.dp_size, single.ep_size, single.batch_axes) == (16, 16, ("data",))
    assert (multi.mesh.shape, multi.mesh.mesh_dim_names) == (
        (2, 16, 16), ("pod", "data", "model"))
    assert (multi.dp_size, multi.ep_size, multi.batch_axes) == (32, 16, ("pod", "data"))
    assert multi.batch_spec(None) == JP(("pod", "data"), None)
    local = make_local_dist(2, 2)
    assert local.mesh.shape == (2, 2) and local.mesh.mesh.tolist() == [[0, 1], [2, 3]]


# --------------------------------------------------------------------------- #
# compression
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(1000,), (3, 700), (256,)])
def test_quantize_int8_matches_reference(shape):
    x = np.random.default_rng(0).normal(0, 0.01, shape).astype(np.float32)
    q, scale, got_shape = quantize_int8(torch.from_numpy(x))
    jq, jscale, jshape = jcomp.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert got_shape == tuple(jshape) == shape and q.dtype == torch.int8
    back = dequantize_int8(q, scale, got_shape)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jcomp.dequantize_int8(jq, jscale, jshape)))
    assert float((back - torch.from_numpy(x)).abs().max()) <= np.abs(x).max() / 127.0 + 1e-9


def test_compressed_psum_matches_reference(tmp_path):
    rng = np.random.default_rng(1)
    g = rng.normal(0, 1e-3, (2, 512)).astype(np.float32)
    e = rng.normal(0, 1e-6, (2, 512)).astype(np.float32)
    mesh = auto_mesh((2,), ("pod",))

    def body(x, err):
        s, new_e = jcomp.compressed_psum({"g": x[0]}, "pod", {"g": err[0]})
        return s["g"][None], new_e["g"][None]

    ref_out, ref_err = jax.jit(shard_map(body, mesh=mesh, in_specs=(JP("pod"), JP("pod")),
                                         out_specs=JP("pod"), check_vma=False))(g, e)
    res = W.run_world(W.compress_worker, 2, tmp_path, {"g": g, "e": e})
    exact = g.sum(axis=0)
    for r, out in enumerate(res):
        assert np.abs(out["out"] - exact).max() < 5e-5
        np.testing.assert_allclose(out["out"], np.asarray(ref_out)[r], rtol=0, atol=1e-7)
        # exact in the port's arithmetic; XLA contracts the reference's
        # subtraction with the dequantizing product (an FMA), an ulp of g
        q, s, shape = quantize_int8(torch.from_numpy(g[r] + e[r]))
        np.testing.assert_array_equal(out["err"], g[r] + e[r] - dequantize_int8(q, s, shape).numpy())
        np.testing.assert_allclose(out["err"], np.asarray(ref_err)[r], rtol=0, atol=1e-9)
        np.testing.assert_allclose(out["mean"], out["out"] / 2, rtol=0, atol=0)
    np.testing.assert_array_equal(res[0]["out"], res[1]["out"])


# --------------------------------------------------------------------------- #
# the optimizers' state specs and their steps on DTensors
# --------------------------------------------------------------------------- #
OPT_KW = {"adamw": dict(lr=1e-2, grad_clip=5.0), "adafactor": dict(lr=1e-2, weight_decay=0.1)}
OPT_SPECS = {"w": (None, "data", "model"), "u": ("model", None), "b": ("data",), "s": ()}


@pytest.fixture(scope="module")
def optimizer_runs(tmp_path_factory):
    """Three steps of each optimizer on LOCAL and on a 2 x 2 mesh (one group
    of 4 ranks), from the same parameters and gradients: ``w`` factored and
    sharded on both of its last dims, ``u`` factored on one, ``b`` and ``s``
    not factored."""
    from repro_torch.train.optimizer import adafactor, adamw
    from repro_torch.train.tree import flatten as tflatten
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((2, 256, 128)), "u": rng.standard_normal((128, 130)),
              "b": rng.standard_normal(64), "s": rng.standard_normal((3, 5))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    grads = [{k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    local = {}
    for name, make in (("adamw", adamw), ("adafactor", adafactor)):
        opt = make(**OPT_KW[name])
        p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        state, norms = opt.init(p), []
        for g in grads:
            p, state, stats = opt.step(p, {k: torch.from_numpy(v) for k, v in g.items()}, state)
            norms.append(float(stats["grad_norm"]))
        local[name] = {"tree": {k: v.numpy() for k, v in tflatten({"p": p, "s": state})},
                       "norms": norms}
    port = W.run_world(W.optimizer_worker, 4, tmp_path_factory.mktemp("opt"),
                       {"params": params, "grads": grads, "kw": OPT_KW, "specs": OPT_SPECS})
    return params, local, port


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_state_specs_and_sharded_step(optimizer_runs, name):
    """``state_specs`` equal the reference's (Adafactor's factored statistics
    inherit the compatible prefix), and three steps on DTensors placed by
    them equal the LOCAL steps within 1e-6: the norms, means and factored
    statistics over leaves split across ranks reduce as on one device."""
    from repro.train import optimizer as jopt
    from repro_torch.train import optimizer as topt
    params, local, port = optimizer_runs
    specs = {k: P(*v) for k, v in OPT_SPECS.items()}
    got = getattr(topt, name)().state_specs(specs, {k: torch.from_numpy(v)
                                                    for k, v in params.items()})
    want = getattr(jopt, name)().state_specs({k: JP(*v) for k, v in OPT_SPECS.items()},
                                             {k: jnp.asarray(v) for k, v in params.items()})
    assert port_flat(got) == ref_flat(want)
    for r in range(4):
        out = port[r][name]
        np.testing.assert_allclose(out["norms"], local[name]["norms"], rtol=1e-6)
        assert out["tree"].keys() == local[name]["tree"].keys()
        for k, v in local[name]["tree"].items():
            np.testing.assert_allclose(out["tree"][k], v, rtol=1e-6, atol=1e-6 * np.abs(v).max(),
                                       err_msg=k)


# --------------------------------------------------------------------------- #
# the expert-parallel dispatch
# --------------------------------------------------------------------------- #
EP_CASES = [(8.0, 8), (1.0, 8), (0.5, 8), (8.0, 1), (1.0, 1), (0.5, 1)]


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    """Both packages' ``moe_ffn_ep`` on a 1 x 2 mesh for every case, the
    port's from one group of 2 ranks, and the port's dense dispatch with its
    gradients."""
    from repro_torch.models import moe
    jcfg = dataclasses.replace(jax_smoke_config(MOE), dtype="float32")
    cfg = W.smoke_f32(MOE)
    p = jax.tree.map(lambda a: np.asarray(a[0]),
                     jmoe.init_moe_ffn(jax.random.PRNGKey(0), jcfg, ep_size=2, n_layers=1))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    jdist = JDist(mesh=auto_mesh((1, 2), ("data", "model")))
    ref = {}
    for cap, s in EP_CASES:
        out, aux = jax.jit(lambda x, c=cap: jmoe.moe_ffn_ep(x, p, jcfg, jdist, capacity_factor=c))(
            jnp.asarray(x[:, :s]))
        ref[(cap, s)] = (np.asarray(out), float(aux))
    dense = {}
    for s in (8, 1):
        xt = torch.from_numpy(x[:, :s]).requires_grad_(True)
        pt = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in p.items()}
        out, _ = moe.moe_ffn_dense(xt, pt, cfg)
        grads = torch.autograd.grad((out * torch.from_numpy(w[:, :s])).sum(),
                                    [xt] + [pt[n] for n in ("router", "we_gate", "we_up",
                                                            "we_down")])
        dense[s] = (out.detach().numpy(), [g.numpy() for g in grads],
                    np.asarray(jmoe.moe_ffn_dense(jnp.asarray(x[:, :s]), p, jcfg)[0]))
    # the serving path on the same mesh: granite-moe's smoke model, f32
    model = japi.init_params(jax.random.PRNGKey(2), jcfg, ep_size=2)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 9)).astype(np.int64)
    cache, prefill_logits = japi.prefill(model, jnp.asarray(tokens[:, :-1], jnp.int32), jcfg,
                                         dist=jdist)
    cache = japi.pad_cache(jcfg, cache, tokens.shape[1])
    _, decode_logits = japi.decode_step(model, cache, jnp.asarray(tokens[:, -1:], jnp.int32),
                                        jcfg, dist=jdist)
    ref["serve"] = {"prefill": np.asarray(prefill_logits), "decode": np.asarray(decode_logits)}
    port = W.run_world(W.ep_worker, 2, tmp_path_factory.mktemp("ep"),
                       {"arch": MOE, "p": p, "x": x, "w": w, "cases": EP_CASES,
                        "model": jax.tree.map(np.asarray, model), "tokens": tokens})
    return ref, dense, port


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_moe_serving_with_dist_matches_reference(ep_runs, phase):
    """``api.prefill`` (8 tokens split over ``model``) and ``api.decode_step``
    (every rank dispatching every token) take ``dist`` and give the
    reference's logits on the same 1 x 2 mesh, capacity drops and all,
    within 1e-5 (f32)."""
    ref, _, port = ep_runs
    for rank in (0, 1):
        np.testing.assert_allclose(port[rank]["serve"][phase], ref["serve"][phase],
                                   rtol=EP_TOL, atol=EP_TOL)


@pytest.mark.parametrize("cap,s", EP_CASES, ids=[f"cap{c}-S{s}" for c, s in EP_CASES])
def test_moe_ffn_ep_matches_reference(ep_runs, cap, s):
    ref, _, port = ep_runs
    want, want_aux = ref[(cap, s)]
    for rank in (0, 1):
        got = port[rank][(cap, s)]
        np.testing.assert_allclose(got["out"], want, rtol=EP_TOL, atol=EP_TOL)
        np.testing.assert_allclose(got["aux"], want_aux, rtol=1e-6)
        assert got["dother"] == 0.0
    np.testing.assert_array_equal(port[0][(cap, s)]["out"], port[1][(cap, s)]["out"])


@pytest.mark.parametrize("s", [8, 1], ids=["S8", "S1"])
def test_moe_ffn_ep_matches_dense_with_gradients(ep_runs, s):
    """At capacity 8.0 nothing drops: the output is the dense dispatch's
    (the reference test's 2e-2 against the reference's dense, and 1e-5),
    and so are the gradients: x and the router whole on each rank, each
    rank's own experts."""
    _, dense, port = ep_runs
    out, grads, ref_dense = dense[s]
    dx, drouter, *dexperts = grads
    for rank in (0, 1):
        got = port[rank][(8.0, s)]
        np.testing.assert_allclose(got["out"], ref_dense, rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(got["out"], out, rtol=EP_TOL, atol=EP_TOL)
        np.testing.assert_allclose(got["dx"], dx, rtol=EP_TOL, atol=EP_TOL)
        np.testing.assert_allclose(got["drouter"], drouter, rtol=EP_TOL, atol=EP_TOL)
    for name, want in zip(("we_gate", "we_up", "we_down"), dexperts):
        whole = np.concatenate([port[0][(8.0, s)][f"d{name}"], port[1][(8.0, s)][f"d{name}"]])
        np.testing.assert_allclose(whole, want, rtol=EP_TOL, atol=EP_TOL, err_msg=name)


# --------------------------------------------------------------------------- #
# elastic restore
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def restores(tmp_path_factory):
    from repro_torch.train import checkpoint as ckpt
    root = tmp_path_factory.mktemp("ckpt")
    _, _, params, state = W._ckpt_trees("qwen1.5-0.5b")
    ckpt.save(root / "local", 3, params, state)
    res = W.run_world(W.ckpt_worker, 4, root / "world",
                      {"arch": "qwen1.5-0.5b", "local_dir": str(root / "local"),
                       "mesh_dir": str(root / "mesh")})
    like_p, like_o = W._ckpt_trees("qwen1.5-0.5b")[2:]
    back = ckpt.restore(root / "mesh", like_p, like_o)
    return res, (params, state), back


@pytest.mark.parametrize("case", ["local_to_2x1", "local_to_2x2", "2x2_to_local"])
def test_elastic_restore_byte_for_byte(restores, case):
    res, (params, state), (got_p, got_o, step) = restores
    if case == "2x2_to_local":
        assert step == 5
        want = flatten({"params": params, "opt_state": state})
        got = flatten({"params": got_p, "opt_state": got_o})
        assert [k for k, _ in got] == [k for k, _ in want]
        for (k, a), (_, b) in zip(got, want):
            assert a.dtype == b.dtype and not isinstance(a, torch.distributed.tensor.DTensor)
            assert torch.equal(a, b), k
        return
    shape = (2, 1) if case == "local_to_2x1" else (2, 2)
    ranks = range(2) if shape == (2, 1) else range(4)
    for r in ranks:
        out = res[r][shape]
        assert out["step"] == 3 and out["equal"] and out["leaves"] > 10
        assert out["sharded_leaves"] > 0


# --------------------------------------------------------------------------- #
# the sharded train step
# --------------------------------------------------------------------------- #
TRAIN_MESHES = [(2, 1), (1, 2), (2, 2)]
TRAIN_CASES = [(arch, mesh) for arch in ("qwen1.5-0.5b", MOE) for mesh in TRAIN_MESHES]
TRAIN = dict(batch=2, seq=16, steps=3, lr=3e-4)


def _case_id(arch, mesh):
    return f"{arch}-{mesh[0]}x{mesh[1]}"


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """The reference's ``make_train_step`` on each Auto mesh (3 steps, f32,
    the trainer's parameters and batches), and the port's sharded step on
    the same parameters from one group of 4 ranks."""
    from repro.train import trainer as jtrainer
    ref, cases = {}, []
    for arch, mesh in TRAIN_CASES:
        jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
        jdist = JDist(mesh=auto_mesh(mesh, ("data", "model")))
        jt = jtrainer.Trainer(jcfg, jtrainer.TrainerConfig(steps=TRAIN["steps"], lr=TRAIN["lr"]),
                              dist=jdist, global_batch=TRAIN["batch"], seq_len=TRAIN["seq"])
        np_params = jax.tree.map(np.array, jt.params)
        # f32 master weights alias the f32 parameters: copies, as the step
        # donates both
        params, state = jax.tree.map(lambda a: jnp.array(a, copy=True),
                                     (jt.params, jt.opt_state))
        metrics = []
        for i in range(TRAIN["steps"]):
            params, state, m = jt.step_fn(params, state, jt.dataset.device_batch_at(i))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        ref[_case_id(arch, mesh)] = metrics
        cases.append({"id": _case_id(arch, mesh), "arch": arch, "mesh": mesh,
                      "params": np_params})
    from repro.models import common as jcm
    jcm.set_shard_hook(None)
    port = W.run_world(W.train_worker, 4, tmp_path_factory.mktemp("train"),
                       dict(TRAIN, cases=cases))
    return ref, port


@pytest.mark.parametrize("arch,mesh", TRAIN_CASES, ids=[_case_id(*c) for c in TRAIN_CASES])
def test_sharded_train_step_matches_reference(train_runs, arch, mesh):
    ref, port = train_runs
    case = _case_id(arch, mesh)
    want_loss, want_norm = zip(*ref[case])
    ranks = range(4) if mesh == (2, 2) else range(2)
    for r in ranks:
        got = port[r][case]
        np.testing.assert_allclose(got["losses"][0], want_loss[0], rtol=STEP_RTOL)
        np.testing.assert_allclose(got["grad_norms"][0], want_norm[0], rtol=STEP_RTOL)
        np.testing.assert_allclose(got["losses"], want_loss, rtol=CURVE_RTOL)
        np.testing.assert_allclose(got["grad_norms"], want_norm, rtol=CURVE_RTOL)
        assert got == port[0][case]
    for r in set(range(4)) - set(ranks):
        assert case not in port[r]


#: the optimizers ``for_arch`` picks: AdamW (qwen) and Adafactor (the VLM,
#: widened so that some leaves factor, as tests/test_torch_train_graphs.py's)
INPLACE_ARCHS = {"qwen1.5-0.5b": {}, "llama-3.2-vision-90b": dict(d_model=128, d_ff=256)}
INPLACE_CASES = [(arch, mesh) for arch in INPLACE_ARCHS for mesh in TRAIN_MESHES]


@pytest.fixture(scope="module")
def inplace_runs(tmp_path_factory):
    """The port's sharded step on each mesh (one group of 4 ranks), two steps
    on a CPU trainer's trees and on copies of them, then a trainer run."""
    cases = [{"id": _case_id(arch, mesh), "arch": arch, "mesh": mesh,
              "wide": INPLACE_ARCHS[arch]} for arch, mesh in INPLACE_CASES]
    return W.run_world(W.inplace_worker, 4, tmp_path_factory.mktemp("inplace"),
                       dict(batch=2, seq=16, cases=cases))


@pytest.mark.parametrize("arch,mesh", INPLACE_CASES, ids=[_case_id(*c) for c in INPLACE_CASES])
def test_sharded_step_keeps_every_local_tensor_in_place(inplace_runs, arch, mesh):
    """What a CUDA graph of the sharded step needs of it: after each of two
    steps every DTensor leaf of the parameters and the optimizer state,
    ``count`` included, is the DTensor passed in with the same local tensor
    at the same address; the trees hold what two steps on copies compute;
    and a ``Trainer`` under a gloo mesh steps eagerly (no graph, no step
    replayed)."""
    case = _case_id(arch, mesh)
    ranks = range(4) if mesh == (2, 2) else range(2)
    for r in ranks:
        got = inplace_runs[r][case]
        assert got["moved"] == [[], []], (r, got["moved"])
        assert got["differ"] == [], (r, got["differ"])
        assert got["count"] == 2 and "['opt_state']['count']" in got["paths"]
        assert got["sharded"] > 0
        assert got["steps_run"] == 1 and got["replayed_steps"] == 0 and not got["graph"]
        if arch == "llama-3.2-vision-90b":      # Adafactor's factored statistics
            assert any("['vr']" in path for path in got["paths"])
    for r in set(range(4)) - set(ranks):
        assert case not in inplace_runs[r]


# --------------------------------------------------------------------------- #
# the what-if config axis
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def whatif_runs(tmp_path_factory):
    from repro_torch.cluster import generate_cluster
    from repro_torch.telemetry import TelemetryStore
    from repro_torch.whatif import evaluate
    d = tmp_path_factory.mktemp("store")
    store = TelemetryStore(d, shard_format="npy_dir")
    generate_cluster(n_devices=6, horizon_s=1500, seed=7, store=store, shard_s=500)
    oracle = evaluate(W.family_grid(), TelemetryStore(d), backend="numpy", compact=True,
                      min_job_duration_s=0.0)
    port = W.run_world(W.whatif_worker, 4, tmp_path_factory.mktemp("whatif"),
                       {"store": str(d)})
    return oracle, port


def assert_oracle_contract(ref, out):
    """tests/test_whatif_backend.py's contract: time and count fields exact,
    float fields within 1e-9 (rtol = atol)."""
    from test_torch_whatif import assert_outcomes_equivalent
    assert_outcomes_equivalent(ref, out)


@pytest.mark.parametrize("mesh", ["config_mesh1", "config_mesh4"])
def test_evaluate_over_config_mesh_matches_oracle(whatif_runs, mesh):
    oracle, port = whatif_runs
    if mesh == "config_mesh1":
        assert_oracle_contract(oracle, port[0]["mesh1"])
        assert ([dataclasses.asdict(o) for o in port[0]["mesh1"]]
                == [dataclasses.asdict(o) for o in port[0]["local"]])
        return
    for r in range(4):
        assert_oracle_contract(oracle, port[r]["mesh4"])
        assert ([dataclasses.asdict(o) for o in port[r]["mesh4"]]
                == [dataclasses.asdict(o) for o in port[0]["mesh4"]])


def test_search_frontier_over_config_mesh(whatif_runs):
    """The same configs in the same order as the search without a mesh,
    every outcome under the oracle contract, on every rank."""
    _, port = whatif_runs
    want = port[0]["search_local"]
    for r in range(4):
        got = port[r]["search4"]
        assert [(t["i"], t["round"], t["family"]) for t in got.frontier.trace] == \
            [(t["i"], t["round"], t["family"]) for t in want.frontier.trace]
        assert [(o.name, o.params, o.pareto) for o in got.frontier.outcomes] == \
            [(o.name, o.params, o.pareto) for o in want.frontier.outcomes]
        assert_oracle_contract(want.frontier.outcomes, got.frontier.outcomes)
        assert (got.n_evals, got.n_rounds) == (want.n_evals, want.n_rounds)
