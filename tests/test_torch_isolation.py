"""The port stands alone: every `repro_torch` module (the hybrid's
config, RG-LRU scan and mixer, the ROK curve, the Table 4 count, the
resilience layer, the pool, aio, fault and factory modules, the cache
manager, the optimizer overlap, the step builders, the dry run, its op
counter and the H100's constants among them), the root `chip_smoke.py` and the port's paper benchmarks
(`benchmarks/torch_*.py`) import with jax and ml_dtypes blocked and load
nothing of the JAX package (`repro` / `repro.*`) nor the JAX benchmarks'
`benchmarks.common`."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
sys.modules["ml_dtypes"] = None
sys.path.insert(0, sys.argv[1] + "/src")
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location(
    "chip_smoke", sys.argv[1] + "/chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
sys.path.insert(0, sys.argv[1])
for bench in ("torch_common", "torch_fig10", "torch_fig11", "torch_table4",
              "torch_fig9", "torch_serve_kv", "torch_trace_split",
              "torch_roofline"):
    importlib.import_module("benchmarks." + bench)
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro.")
             or m == "benchmarks.common")
print(len(names), "modules;", "leaked:", bad)
print(" ".join(names))
sys.exit(1 if bad else 0)
"""


def test_port_imports_without_jax_or_the_jax_package():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)      # nothing but the port on the path
    proc = subprocess.run([sys.executable, "-c", PROBE, ROOT],
                          capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20, proc.stdout
    assert "leaked: []" in proc.stdout
    names = proc.stdout.splitlines()[1].split()
    for module in ("configs.recurrentgemma_9b", "kernels.rglru_scan",
                   "models.rglru", "models.layers", "models.transformer",
                   "core.rok", "core.endurance", "resilience.retry",
                   "resilience.health", "resilience.chaos", "io.bufpool",
                   "io.aio", "io.faults", "io.factory", "cache.placement",
                   "cache.manager", "launch.cacheargs", "optim.overlap",
                   "launch.steps", "parallel.pipeline",
                   "parallel.compress", "launch.mesh", "launch.op_stats",
                   "launch.dryrun"):
        assert f"repro_torch.{module}" in names, module
