"""Paper Fig. 9 from the port: projected SSD lifespan, per-GPU PCIe write
rate and activations per GPU for the Megatron-scale systems the paper
cites (`repro_torch.core.endurance.project_all`), after
`benchmarks/fig9_endurance.py`, row for row.

    PYTHONPATH=src python -m benchmarks.torch_fig9

The projection is arithmetic on the paper's A100 and 4x D7-P5810 per
GPU figures (§3.4), not a measurement: it runs on the CPU and touches
no card. Claims checked as in the JAX script: every configuration
projects more than 3 years of SSD life, and the write rate stays at or
below 15 GB/s.
"""
from __future__ import annotations

from repro_torch.core.endurance import project_all


def main():
    rows = project_all()
    print("name,us_per_call,derived")
    for p in rows:
        print(f"fig9/{p.label.replace(' ', '-')},"
              f"{p.t_step_s*1e6:.0f},"
              f"pcie_gb_s={p.pcie_write_gb_s:.1f}"
              f";lifespan_yr={p.lifespan_years:.1f}"
              f";act_per_gpu_gb={p.act_bytes_per_gpu/1e9:.1f}")
    ok_life = all(p.lifespan_years > 3 for p in rows)
    ok_bw = all(p.pcie_write_gb_s <= 15 for p in rows)
    print(f"fig9/claims,0,lifespan_gt_3yr={ok_life};bw_le_15gbs={ok_bw}")
    return rows


if __name__ == "__main__":
    main()
