"""Fig. 9 and the exact residual counter in the port
(`repro_torch.core.endurance`), against the JAX package and against the
port's own engine, on the CPU.

  * `project_all()` equals JAX's field for field, and
    `benchmarks/torch_fig9.py` prints `benchmarks/fig9_endurance.py`'s
    rows and claims line.
  * `project_device_lifespans` over the port's striped backend's
    per-device bytes equals JAX's on the same numbers.
  * `residual_bytes_per_layer` on small-gpt (float32, plain attention)
    equals what the engine's pack hook keeps for each layer stage (every
    saved tensor), and what the spool stores for the layer stages at the
    paper's 2^20-element filter.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from benchmarks import fig9_endurance, torch_fig9  # noqa: E402
from repro.core import endurance as jend  # noqa: E402
from repro_torch.configs import SpoolIoConfig  # noqa: E402
from repro_torch.configs.paper_models import small_gpt  # noqa: E402
from repro_torch.core import endurance  # noqa: E402
from repro_torch.core.engine import StagedEngine  # noqa: E402
from repro_torch.core.policies import SpoolPolicy  # noqa: E402
from repro_torch.core.spool import ActivationSpool  # noqa: E402
from repro_torch.io.backends import StripedBackend  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.transformer import RunSettings  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401


def test_projection_matches_jax(capsys):
    got = [dataclasses.asdict(p) for p in endurance.project_all()]
    want = [dataclasses.asdict(p) for p in jend.project_all()]
    assert got == want and len(got) == 6
    assert [dataclasses.asdict(s) for s in endurance.MEGATRON_SYSTEMS] \
        == [dataclasses.asdict(s) for s in jend.MEGATRON_SYSTEMS]
    assert endurance.MIN_OFFLOAD_ELEMENTS == jend.MIN_OFFLOAD_ELEMENTS
    fig9_endurance.main()
    want_out = capsys.readouterr().out
    torch_fig9.main()
    got_out = capsys.readouterr().out
    assert got_out == want_out
    assert "lifespan_gt_3yr=True;bw_le_15gbs=True" in got_out


def test_device_lifespans_over_striped_bytes_match_jax(tmp_path):
    b = StripedBackend([str(tmp_path / f"ssd{i}") for i in range(4)],
                       chunk_bytes=1 << 10)
    for i in range(6):
        b.write(f"k{i}", np.frombuffer(os.urandom((5 + i) << 10), np.uint8))
    per_dev = b.per_device_write_bytes()
    assert sum(per_dev) == sum((5 + i) << 10 for i in range(6))
    labels = [f"ssd{i}" for i in range(4)]
    got = endurance.project_device_lifespans(per_dev, 7.5, labels=labels)
    want = jend.project_device_lifespans(per_dev, 7.5, labels=labels)
    assert [dataclasses.asdict(w) for w in got] == \
        [dataclasses.asdict(w) for w in want]
    with pytest.raises(ValueError, match="positive"):
        endurance.project_device_lifespans(per_dev, 0.0)


def test_residual_counter_equals_the_engines_bytes(monkeypatch):
    """B=2, S=1024 at hidden 128: the MLP's (B, S, 4h) tensors pass the
    2^20-element filter, the (B, S, h) ones do not. The head runs the
    chunked CE, so it stores nothing at that filter either."""
    cfg = dataclasses.replace(small_gpt(128, 2), dtype="float32")
    B, S = 2, 1024
    stored = []
    real = ActivationSpool.offload

    def spy(self, key, tree):
        real(self, key, tree)
        rec = self._records[key]
        stored.append(sum(tree[i].numel() * tree[i].element_size()
                          for i in rec["spool_idx"]))

    monkeypatch.setattr(ActivationSpool, "offload", spy)
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    opt = topt.sgd(1e-3)
    eng = StagedEngine(api, RunSettings(attn_impl="torch", attn_chunk=256,
                                        param_dtype="float32", device="cpu",
                                        ce_chunk=256),
                       opt, policy=SpoolPolicy(),
                       io_config=SpoolIoConfig(backend="mem"))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    try:
        _, _, rep = eng.train_step(params, opt.init(params), [
            {"tokens": toks[:, :-1], "labels": toks[:, 1:]}])
    finally:
        eng.close()
    every = endurance.residual_bytes_per_layer(
        cfg, B, S, offloadable_only=False, attn_impl="torch")
    big = endurance.residual_bytes_per_layer(cfg, B, S, attn_impl="torch")
    assert rep.extra["layer_saved_bytes"] == cfg.num_layers * every
    names = eng.stage_names
    layers = [n for st, n in zip(stored, names) if n.startswith("seg")]
    assert len(layers) == cfg.num_layers
    assert [st for st, n in zip(stored, names) if n.startswith("seg")] \
        == [big] * cfg.num_layers
    assert 0 < big < every
    assert sum(stored) == cfg.num_layers * big      # embed, head: none
