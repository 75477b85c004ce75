"""The port's checkpoints (`repro_torch.ckpt`) against the JAX package's
`repro.ckpt`: one layout, so either package restores the other's.

  * small-gpt parameters and the optimizer state after one update, for
    sgd, sgd-momentum and adamw, in float32 and in bfloat16: a
    port-written checkpoint restores through the JAX package's
    `restore_checkpoint` and a JAX-written one through the port's, both
    bitwise, and the two manifests list the same leaves, shapes and
    dtypes;
  * a partial `.tmp` dir and a torn committed dir are skipped; an
    explicitly requested torn step, a shape mismatch and a missing leaf
    raise;
  * the manager's async save holds the values of the step it was given,
    though the caller updates the tensors in place right after `save`
    returns, and `keep_last` GC keeps the newest steps.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs.paper_models import small_gpt as jax_small_gpt  # noqa
from repro.models.api import build_model as jax_build  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.ckpt import checkpoint as tckpt  # noqa: E402
from repro_torch.core.tree import tree_flatten, tree_unflatten  # noqa
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

OPTS = {"sgd": (lambda m: m.sgd(1e-2)),
        "sgd-momentum": (lambda m: m.sgd(1e-2, momentum=0.9)),
        "adamw": (lambda m: m.adamw(1e-3))}


def _jax_state(opt_name, dtype):
    """JAX small-gpt params and the optimizer state after one update on
    seeded random gradients."""
    cfg = dataclasses.replace(jax_small_gpt(128, 2), dtype=dtype)
    params = jax_build(cfg).init(jax.random.key(0))
    rng = np.random.default_rng(1)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape), p.dtype), params)
    opt = OPTS[opt_name](jopt)
    params, state = opt.update(grads, opt.init(params), params)
    return {"params": params, "opt_state": state}


def _to_port(jtree):
    """The same tree in the port: tensors, `OptState.step` an int."""
    host = jax.tree.map(np.asarray, jtree)
    st = host["opt_state"]
    return {"params": params_from_jax(host["params"], device="cpu"),
            "opt_state": topt.OptState(
                int(st.step),
                None if st.mu is None else params_from_jax(st.mu,
                                                           device="cpu"),
                None if st.nu is None else params_from_jax(st.nu,
                                                           device="cpu"))}


def _zeros_like(tree):
    if tree is None:
        return None
    leaves, tdef = tree_flatten(tree)
    return tree_unflatten(tdef, [torch.zeros_like(t) for t in leaves])


def _port_like(ttree):
    """Zeros of the same structure (restore targets)."""
    st = ttree["opt_state"]
    return {"params": _zeros_like(ttree["params"]),
            "opt_state": topt.OptState(0, _zeros_like(st.mu),
                                       _zeros_like(st.nu))}


def _assert_port_equal(got, want):
    for (kg, g), (kw, w) in zip(tckpt.flatten_with_paths(got),
                                tckpt.flatten_with_paths(want)):
        assert kg == kw
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), kg
        else:
            assert type(g) is int and g == w, kg


def _assert_jax_equal(got, want):
    gl, wl = (jax.tree_util.tree_flatten_with_path(t)[0]
              for t in (got, want))
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert np.array_equal(g.reshape(-1).view(np.uint8),
                              w.reshape(-1).view(np.uint8)), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt_name", sorted(OPTS))
def test_checkpoints_cross_packages_bitwise(tmp_path, opt_name, dtype):
    jtree = _jax_state(opt_name, dtype)
    ttree = _to_port(jtree)
    assert ttree["opt_state"].step == 1
    # the port writes, the JAX package reads
    tckpt.save_checkpoint(str(tmp_path / "t"), 5, ttree,
                          metadata={"data": {"step": 5}})
    got, manifest = jckpt.restore_checkpoint(str(tmp_path / "t"), jtree)
    assert manifest["step"] == 5 and manifest["metadata"]["data"] == {
        "step": 5}
    _assert_jax_equal(got, jtree)
    # the JAX package writes, the port reads
    jckpt.save_checkpoint(str(tmp_path / "j"), 5, jtree)
    got, _ = tckpt.restore_checkpoint(str(tmp_path / "j"),
                                      _port_like(ttree), device="cpu")
    _assert_port_equal(got, ttree)
    # one layout: the same leaves, shapes and dtypes in both manifests
    leaves = [json.load(open(tmp_path / d / "step_00000005" /
                             "manifest.json"))["leaves"] for d in "tj"]
    assert leaves[0] == leaves[1]
    assert leaves[0]["opt_state/.step"] == {"shape": [], "dtype": "int32"}
    if dtype == "bfloat16":
        assert leaves[0]["params/embed"]["dtype"] == "bfloat16"
    assert ("opt_state/.nu/embed" in leaves[0]) == (opt_name == "adamw")
    assert ("opt_state/.mu/embed" in leaves[0]) == (opt_name != "sgd")


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(16, 8, generator=g),
            "nested": {"b": torch.randn(4, generator=g).to(torch.bfloat16),
                       "c": [torch.arange(5), torch.zeros(2, 2)]}}


def test_partial_and_torn_checkpoints_are_skipped(tmp_path):
    d = str(tmp_path)
    tckpt.save_checkpoint(d, 1, _tree(1))
    tckpt.save_checkpoint(d, 2, _tree(2))
    # a crash mid-write of step 3, and a committed step 2 whose npz tore
    os.makedirs(os.path.join(d, "step_00000003.tmp"))
    npz = os.path.join(d, "step_00000002", "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    with pytest.warns(UserWarning, match="partial/corrupt"):
        assert tckpt.latest_step(d) == 1
    with pytest.warns(UserWarning):
        got, manifest = tckpt.restore_checkpoint(d, _tree())
    assert manifest["step"] == 1
    _assert_port_equal(got, _tree(1))
    with pytest.raises(ValueError, match="partial or corrupt"):
        tckpt.restore_checkpoint(d, _tree(), step=2)
    with pytest.warns(UserWarning):
        assert jckpt.latest_step(d) == 1    # the JAX package skips them too


def test_shape_mismatch_and_missing_leaf_raise(tmp_path):
    d = str(tmp_path)
    tckpt.save_checkpoint(d, 1, {"a": torch.zeros(4, 4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore_checkpoint(d, {"a": torch.zeros(8, 8)})
    with pytest.raises(KeyError, match="missing leaf"):
        tckpt.restore_checkpoint(d, {"a": torch.zeros(4, 4),
                                     "b": torch.zeros(1)})


def test_in_place_restore_writes_into_the_given_tensors(tmp_path):
    d = str(tmp_path)
    tckpt.save_checkpoint(d, 1, _tree())
    leaves, treedef = tree_flatten(_tree())
    like = tree_unflatten(treedef, [torch.zeros_like(t) for t in leaves])
    got, _ = tckpt.restore_checkpoint(d, like, in_place=True)
    for g, w, t in zip(tree_flatten(got)[0], tree_flatten(like)[0], leaves):
        assert g is w and g.dtype == t.dtype and torch.equal(g, t)
    with pytest.raises(ValueError, match="dtype mismatch"):
        tckpt.restore_checkpoint(d, {**like, "a": like["a"].double()},
                                 in_place=True)
    with pytest.raises(ValueError, match="own devices"):
        tckpt.restore_checkpoint(d, like, in_place=True, device="cpu")


def test_async_save_snapshots_at_save_and_gc_keeps_the_newest(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep_last=2)
    w = torch.zeros(256, 256)
    for s in (1, 2, 3, 4):
        w.fill_(float(s))
        mgr.save(s, {"w": w}, metadata={"s": s})
        w.fill_(-1.0)       # the in-place update of the next step
    mgr.wait()
    assert sorted(os.listdir(str(tmp_path))) == ["step_00000003",
                                                 "step_00000004"]
    for s in (3, 4):
        got, manifest = mgr.restore({"w": w}, step=s)
        assert torch.equal(got["w"], torch.full((256, 256), float(s)))
        assert manifest["metadata"] == {"s": s}
    assert mgr.last_write_s > 0


def test_the_reader_reads_what_np_savez_writes(tmp_path):
    """A restore reads `arrays.npz` members from their offsets in large
    calls (`ckpt/checkpoint.py::_NpzReader`): the arrays `np.savez`
    writes come back bitwise, a 0-d and an empty one included, and a
    member it does not write (compressed, Fortran-ordered) is refused."""
    arrays = {"a|b": np.arange(10 ** 5, dtype=np.float32).reshape(100, -1),
              "step": np.asarray(3, np.int32),
              "bf": np.arange(12, dtype=np.uint16).reshape(3, 4),
              "empty": np.zeros((0, 3), np.float32)}
    path = str(tmp_path / "a.npz")
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    with tckpt._NpzReader(path) as data:
        for name, want in arrays.items():
            got = data[name]
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(got, want), name
    for bad, write in (("z.npz", lambda f: np.savez_compressed(f, **arrays)),
                       ("f.npz", lambda f: np.savez(f, x=np.asfortranarray(
                           arrays["a|b"])))):
        with open(tmp_path / bad, "wb") as f:
            write(f)
        with tckpt._NpzReader(str(tmp_path / bad)) as data:
            with pytest.raises(ValueError, match="np.savez"):
                data["x" if bad == "f.npz" else "step"]
