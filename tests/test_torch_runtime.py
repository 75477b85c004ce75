"""The port's training loop (`repro_torch.runtime.trainer.TrainLoop`) and
the session's checkpoints, against the JAX package's `TrainLoop` and
against uninterrupted runs.

  * The JAX loop's own cases (tests/test_runtime.py) on the port's loop:
    restart bitwise, preemption's final checkpoint, the watchdog, the
    metrics JSONL, a finite loader ending cleanly, tokens/s over real
    targets; the port's loop and the JAX loop give the same parameters
    on the same stream.
  * A spool session on `fs` runs 2 steps and checkpoints; a new session
    resumes and runs 1: losses and parameters bitwise equal to 3 steps
    uninterrupted, and the data cursor restored. A preemption (by
    `request_preemption` or by SIGTERM) stops at the step boundary with
    a final checkpoint; without a ckpt_dir nothing is written.
  * The CLI accepts --ckpt/--ckpt-every/--resume/--trace/--trace-ring.
  * The loader's cursor restores backwards as well as forwards while
    its prefetch thread runs ahead.
"""
import dataclasses
import json
import os
import signal
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data.pipeline import ShardedLoader as JaxLoader  # noqa: E402
from repro.data.pipeline import SyntheticMarkovLM as JaxMarkov  # noqa: E402
from repro.runtime import trainer as jtrainer  # noqa: E402
from repro_torch.configs import SpoolIoConfig  # noqa: E402
from repro_torch.configs.paper_models import small_gpt  # noqa: E402
from repro_torch.core.tree import tree_flatten  # noqa: E402
from repro_torch.data.pipeline import (ShardedLoader,  # noqa: E402
                                       SyntheticMarkovLM)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.obs.export import validate_trace  # noqa: E402
from repro_torch.runtime.trainer import (StragglerWatchdog,  # noqa: E402
                                         TrainLoop, TrainState)
from repro_torch.session import TrainSession  # noqa: E402

B, S = 2, 32
MIN_OFF = 2 ** 10


def _torch_step(slow_steps=()):
    calls = {"n": 0}

    def step_fn(params, opt_state, batch):
        calls["n"] += 1
        if calls["n"] in slow_steps:
            time.sleep(0.25)
        g = torch.as_tensor(batch["tokens"], dtype=torch.float32).mean()
        params = {"w": params["w"] - 0.01 * (params["w"] - g)}
        return params, opt_state, {"loss": float(params["w"].sum())}

    return step_fn


def _loop(ckpt_dir, metrics=None, slow_steps=(), loader=None):
    loader = loader if loader is not None else ShardedLoader(
        SyntheticMarkovLM(128, seed=9), global_batch=4, seq_len=8,
        prefetch=0)
    return TrainLoop(step_fn=_torch_step(slow_steps),
                     init_state=TrainState(0, {"w": torch.zeros(2)}, {}),
                     loader=loader, ckpt_dir=ckpt_dir, ckpt_every=5,
                     metrics_path=metrics,
                     watchdog=StragglerWatchdog(window=16, threshold=2.0))


def test_loop_restart_is_bitwise_and_matches_the_jax_loop(tmp_path):
    loop_a = _loop(str(tmp_path / "a"))
    final_a = loop_a.run(20)
    loop_b1 = _loop(str(tmp_path / "b"))
    loop_b1.run(10)
    loop_b2 = _loop(str(tmp_path / "b"))
    assert loop_b2.resume() and loop_b2.state.step == 10
    final_b = loop_b2.run(10)
    assert final_a.step == final_b.step == 20
    assert torch.equal(final_a.params["w"], final_b.params["w"])

    def jstep(params, opt_state, batch):
        g = jnp.asarray(batch["tokens"], jnp.float32).mean()
        return {"w": params["w"] - 0.01 * (params["w"] - g)}, opt_state, {}

    jloop = jtrainer.TrainLoop(
        step_fn=jstep, init_state=jtrainer.TrainState(
            0, {"w": jnp.zeros((2,))}, {}),
        loader=JaxLoader(JaxMarkov(128, seed=9), global_batch=4, seq_len=8,
                         prefetch=0),
        ckpt_dir=str(tmp_path / "j"), ckpt_every=0)
    jfinal = jloop.run(20)
    jloop.close()
    np.testing.assert_allclose(final_a.params["w"].numpy(),
                               np.asarray(jfinal.params["w"]), rtol=1e-6)


def test_preemption_saves_a_final_checkpoint(tmp_path):
    loop = _loop(str(tmp_path))
    loop.request_preemption()        # the scheduler's SIGTERM, before a step
    final = loop.run(50)
    loop.close()
    assert final.step == 0 and loop.preempted
    assert loop.ckpt.latest_step() == 0


def test_watchdog_flags_slow_steps(tmp_path):
    loop = _loop(str(tmp_path), slow_steps={15, 16})
    loop.run(20)
    assert {15, 16} & {f["step"] for f in loop.watchdog.flagged}


def test_metrics_jsonl_and_tokens_over_real_targets(tmp_path):
    path = str(tmp_path / "m.jsonl")
    loop = _loop(str(tmp_path), metrics=path)
    loop.run(5)
    loop.close()
    rows = [json.loads(line) for line in open(path)]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5]
    assert all("step_time_s" in r and "loss" in r for r in rows)
    # labels < 0 are padding: 6 real targets of 16 positions
    labels = np.full((2, 8), -1)
    labels[:, :3] = 5
    loop = _loop(str(tmp_path / "p"), metrics=str(tmp_path / "p.jsonl"),
                 loader=[{"tokens": np.zeros((2, 8), np.int32),
                          "labels": labels}])
    loop.run(1)
    loop.close()
    rec = json.loads(open(tmp_path / "p.jsonl").readline())
    assert abs(rec["tokens_per_s"] * rec["step_time_s"] - 6) < 1e-6 * 6


def test_finite_loader_ends_cleanly_with_a_final_checkpoint(tmp_path):
    batches = [{"tokens": np.full((2, 4), i)} for i in range(3)]
    loop = _loop(str(tmp_path), loader=batches)
    final = loop.run(10)
    loop.close()
    assert final.step == 3 and loop.ckpt.latest_step() == 3


def test_loop_refuses_what_is_not_ported(tmp_path):
    for kw in ({"host_offload": "opt_state"}, {"host_offload": True},
               {"opt_bridge": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TrainLoop(step_fn=_torch_step(), init_state=TrainState(0, {}, {}),
                      loader=[], **kw)


def _cfg():
    return dataclasses.replace(small_gpt(128, 2), dtype="float32")


def _session(tmp_path, name, **kw):
    return TrainSession(
        _cfg(), device="cpu", policy="spool", optimizer="adamw",
        batch_size=B, seq_len=S, min_offload_elements=MIN_OFF,
        io=SpoolIoConfig(backend="fs", directory=str(tmp_path / name)),
        **kw)


def _params(sess):
    return [t.detach().clone() for t in tree_flatten(sess.params)[0]]


def test_session_resume_is_bitwise(tmp_path):
    with _session(tmp_path, "whole") as s:
        whole = s.run(3).losses
        p_whole = _params(s)
    ckpt = str(tmp_path / "ckpt")
    with _session(tmp_path, "first", ckpt_dir=ckpt, ckpt_every=2) as s:
        first = s.run(2).losses
    manifest = json.load(open(os.path.join(ckpt, "step_00000002",
                                           "manifest.json")))
    assert manifest["metadata"]["data"]["step"] == 2
    assert manifest["metadata"]["final"] is True
    with _session(tmp_path, "second", ckpt_dir=ckpt) as s:
        s.init()
        storages = [t.data_ptr() for t in tree_flatten(s.params)[0]]
        res = s.run(1, resume=True)
        assert s.step == 3 and s.opt_state.step == 3
        assert [r.step for r in res.reports] == [3]
        # restored into the initial tensors: one copy of the model
        assert [t.data_ptr() for t in tree_flatten(s.params)[0]] == storages
        p_resumed = _params(s)
    assert first + res.losses == whole
    assert all(torch.equal(a, b) for a, b in zip(p_whole, p_resumed))
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000003"]


@pytest.mark.parametrize("how", ["request", "sigterm"])
def test_session_preemption_stops_with_a_final_checkpoint(tmp_path, how):
    ckpt = str(tmp_path / "ckpt")
    before = signal.getsignal(signal.SIGTERM)
    with _session(tmp_path, "s", ckpt_dir=ckpt, ckpt_every=0,
                  install_signal_handlers=True) as s:
        def on_report(rep):
            if rep.step == 1:
                if how == "request":
                    s.request_preemption()
                else:
                    os.kill(os.getpid(), signal.SIGTERM)

        res = s.run(5, on_report=on_report)
        assert [r.step for r in res.reports] == [1] and s.preempted
    assert os.listdir(ckpt) == ["step_00000001"]
    assert signal.getsignal(signal.SIGTERM) is before


def test_no_ckpt_dir_writes_no_checkpoint(tmp_path):
    with _session(tmp_path, "s") as s:
        s.run(1)
        assert s.ckpt is None
        with pytest.raises(ValueError, match="ckpt_dir"):
            s.run(1, resume=True)
    assert sorted(os.listdir(tmp_path)) == ["s"]


def test_cli_checkpoints_resumes_and_traces(tmp_path, capsys):
    common = ["--arch", "small-gpt", "--device", "cpu", "--batch", "2",
              "--seq", "32", "--strategy", "spool", "--min-offload", "4096",
              "--ckpt", str(tmp_path / "ckpt")]
    trace = str(tmp_path / "t.json")
    train_cli.main(common + ["--steps", "2", "--ckpt-every", "1",
                             "--trace", trace, "--trace-ring", "4096"])
    out = capsys.readouterr().out
    assert "checkpoint: step 2" in out and "overlap (last step):" in out
    assert f"trace written to {trace}" in out
    assert validate_trace(trace, ("engine", "spool", "io")) == []
    train_cli.main(common + ["--steps", "1", "--resume"])
    out = capsys.readouterr().out
    assert "step    3 loss" in out and "checkpoint: step 3" in out


def test_loader_cursor_restores_backwards_with_prefetch():
    src = SyntheticMarkovLM(128, seed=3)
    want = [src.batch(0, i, 2, 8)["tokens"] for i in range(6)]
    loader = ShardedLoader(src, global_batch=2, seq_len=8, prefetch=2)
    try:
        for i in range(5):
            assert np.array_equal(next(loader)["tokens"], want[i])
        loader.load_state_dict({"step": 1})
        assert np.array_equal(next(loader)["tokens"], want[1])
        loader.load_state_dict({"step": 4})
        assert np.array_equal(next(loader)["tokens"], want[4])
        assert loader.state_dict()["step"] == 5
    finally:
        loader.close()
