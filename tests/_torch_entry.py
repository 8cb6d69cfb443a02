"""Running the port's entry points (``examples/*_torch.py``,
``scripts/*_torch.py``) from the tests: as subprocesses, or imported."""
import importlib.util
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ["quickstart_torch", "incremental_workload_torch",
            "edge_tiling_torch", "serve_lm_torch",
            "continuous_batching_torch"]
SCRIPTS = ["smoke_models_torch", "server_smoke_torch", "cluster_smoke_torch"]


def path_of(name: str) -> pathlib.Path:
    return ROOT / ("examples" if name in EXAMPLES else "scripts") / \
        f"{name}.py"


def run(name: str, *args: str, timeout: float = 600):
    """``python <entry point> *args`` from the repo root, ``src`` on the
    path.  Each process of it takes at most two OpenMP threads unless the
    environment says otherwise: the suite runs in several workers at
    once, and a CPU decode whose thread teams outnumber the cores many
    times over can stall for minutes."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "2")
    return subprocess.run([sys.executable, str(path_of(name)), *args],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)


def load(name: str):
    """The entry point as a module (its ``main`` and functions)."""
    spec = importlib.util.spec_from_file_location(name, path_of(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
