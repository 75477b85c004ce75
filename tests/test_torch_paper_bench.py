"""The port's paper-benchmark layers against the JAX package's, on the
CPU: the ROK curve's dominance and Pareto front (`core/rok.py`), the
analytic Table 4 count (`core/endurance.py`) exactly, and against the
paper's own Table 4 estimates within 10%; and the rows of
`benchmarks/torch_fig10.py`, `torch_fig11.py` and `torch_table4.py` at
one tiny scenario carry the keys of the JAX scripts' rows (each JAX
script run at the same tiny scenario)."""
import dataclasses
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs import paper_models as jpm  # noqa: E402
from repro.configs.mamba2_2_7b import CONFIG as JAX_MAMBA2  # noqa: E402
from repro.configs.recurrentgemma_9b import CONFIG as JAX_RG  # noqa: E402
from repro.core import endurance as jend  # noqa: E402
from repro.core import rok as jrok  # noqa: E402
from repro_torch.configs import (MAMBA2_2_7B, RECURRENTGEMMA_9B,  # noqa
                                 bert, gpt)
from repro_torch.core import endurance as tend  # noqa: E402
from repro_torch.core import rok as trok  # noqa: E402
from test_endurance_rok import PAPER_TABLE4  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from benchmarks import fig10_overhead, fig11_rok, table4_offload  # noqa
from benchmarks import torch_fig10, torch_fig11, torch_table4  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

TINY = [(128, 1)]       # (hidden, layers): one small layer per family
# T5 splits its layers into encoder and decoder: one of each
TINY_T5 = [(128, 2)]


def _points(mod, seed):
    rng = np.random.default_rng(seed)
    pts = []
    for i in range(12):
        peak = int(rng.integers(1, 6)) * 10     # ties on either axis
        step = float(rng.integers(1, 5)) / 4
        pts.append(mod.RokPoint(("keep", "offload", "recompute")[i % 3],
                                4 << (i % 3), peak, step,
                                mod.model_flops_per_step(1e6, 1024)))
    return pts


@pytest.mark.parametrize("seed", range(4))
def test_rok_dominance_and_front_match_jax(seed):
    tp, jp = _points(trok, seed), _points(jrok, seed)
    for a_t, a_j in zip(tp, jp):
        assert a_t.as_dict() == a_j.as_dict()
        for b_t, b_j in zip(tp, jp):
            assert trok.dominates(a_t, b_t) == jrok.dominates(a_j, b_j)
    assert ([p.as_dict() for p in trok.pareto_front(tp)]
            == [p.as_dict() for p in jrok.pareto_front(jp)])


def test_rok_curve_round_trips(tmp_path):
    pts = _points(trok, 9)
    trok.save_curve(pts, str(tmp_path / "c.json"))
    assert trok.load_curve(str(tmp_path / "c.json")) == pts
    # the JAX package reads the port's file
    assert ([p.as_dict() for p in jrok.load_curve(str(tmp_path / "c.json"))]
            == [p.as_dict() for p in pts])


CONFIGS = {
    "bert": (lambda: bert(8192, 4), lambda: jpm.bert(8192, 4)),
    "gpt": (lambda: gpt(12288, 3), lambda: jpm.gpt(12288, 3)),
    "mamba2-2.7b": (lambda: MAMBA2_2_7B, lambda: JAX_MAMBA2),
    "recurrentgemma-9b": (lambda: RECURRENTGEMMA_9B, lambda: JAX_RG),
}


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_analytic_count_equals_jax(name, dtype, tp):
    port, jax_cfg = (dataclasses.replace(f(), dtype=dtype)
                     for f in CONFIGS[name])
    assert (tend.analytic_bytes_per_token_per_layer(port, tp=tp)
            == jend.analytic_bytes_per_token_per_layer(jax_cfg, tp=tp))
    assert (tend.offloaded_bytes_per_step(port, 16, 1024, tp=tp)
            == jend.offloaded_bytes_per_step(jax_cfg, 16, 1024, tp=tp))


@pytest.mark.parametrize("hl,paper_gb", PAPER_TABLE4.items())
def test_table4_estimate_matches_paper(hl, paper_gb):
    """The paper's Table 4 (BERT, batch 16, seq 1024, fp16, TP=2):
    within 10% of its own estimate, as tests/test_endurance_rok.py."""
    cfg = dataclasses.replace(bert(*hl), dtype="float16")
    est_gb = tend.offloaded_bytes_per_step(cfg, 16, 1024, tp=2) / 1e9
    assert abs(est_gb - paper_gb) / paper_gb < 0.10, (est_gb, paper_gb)


def test_fig10_rows_carry_the_jax_keys(monkeypatch, tmp_path):
    monkeypatch.setattr(fig10_overhead, "SMALL_SCENARIOS", TINY_T5)
    monkeypatch.setattr(fig10_overhead, "FAMILIES", {"t5": jpm.small_t5})
    want = set(fig10_overhead.run(batch=2, seq=16, steps=1)[0])
    rows = torch_fig10.run(batch=2, seq=16, steps=1, scenarios=TINY_T5,
                           device="cpu", spool_parent=str(tmp_path))
    assert [r["family"] for r in rows] == ["gpt", "bert", "t5"]
    for r in rows:
        assert want <= set(r), want - set(r)
        # through the spool: written, or forwarded from the host copy
        assert r["batch"] == 2 and r["offloaded_mb"] + r["forwarded_mb"] > 0
        assert r["device"] == "cpu" and r["spool_fs"]
    assert list(tmp_path.iterdir()) == []


def test_fig11_rows_carry_the_jax_keys(tmp_path):
    kw = dict(batches=(2,), seq=16, hidden=128, layers=1, steps=1)
    want = set(fig11_rok.run(**kw)[0].as_dict())
    rows = torch_fig11.run(**kw, device="cpu", spool_parent=str(tmp_path))
    assert [r["strategy"] for r in rows] == ["keep", "spool", "recompute"]
    for r in rows:
        assert r["fits"] and want <= set(r), want - set(r)
    assert any(r["pareto"] for r in rows)


def test_table4_rows_carry_the_jax_keys(monkeypatch, tmp_path):
    monkeypatch.setattr(table4_offload, "SMALL_SCENARIOS", TINY)
    want = set(table4_offload.run(batch=2, seq=16, steps=1)[0])
    rows = torch_table4.run(batch=2, seq=16, steps=1, scenarios=TINY,
                            device="cpu", spool_parent=str(tmp_path))
    assert len(rows) == 1 and want <= set(rows[0]), want - set(rows[0])
    r = rows[0]
    # what lands is timing-dependent (a store still queued when backward
    # fetches it is forwarded, not written); what the layers hand over is not
    assert r["measured_mb"] >= 0 and r["layer_saved_mb"] > 0
    # the exact counter, on the meta device, is what the layers hand over
    assert r["layer_exact_mb"] == r["layer_saved_mb"]
    assert r["ratio"] == r["measured_mb"] / r["estimate_mb"]
    assert r["dtype"] == "float32"


@pytest.mark.parametrize("argv", [[], ["--paper"], ["--paper", "--device",
                                                    "cpu"]])
@pytest.mark.parametrize("script", [torch_fig10, torch_fig11, torch_table4])
def test_scripts_run_on_the_card_unless_asked_for_the_cpu(script, argv,
                                                          monkeypatch):
    """The default device is the card: without CUDA the script stops
    before it runs anything, and `--paper` refuses the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        script.main(argv)
    assert e.value.code not in (0, None)
