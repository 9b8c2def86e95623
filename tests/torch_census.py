"""The port's ``ci`` dry-run census, made once a pytest run: ``python
-m repro_torch.launch.dryrun --preset ci``'s 80 cells (both meshes),
shared by ``test_torch_dryrun.py`` and ``test_torch_spmd_lint.py``.

Under xdist the workers share one directory beside their own temporary
roots; the first to take the lock runs the sweep and the others read
its results.
"""
import fcntl
import json
import os

from repro_torch.launch.dryrun import run_all
from repro_torch.launch.presets import CI


def ci_census(tmp_path_factory):
    """``(root, out, results)``: an artifact root whose
    ``dryrun/ci/`` holds the census's cells and manifest, that
    directory, and the sweep's results in its order."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    root = base / "torch-ci-census"
    out = root / "dryrun" / "ci"
    done = root / "results.json"
    root.mkdir(parents=True, exist_ok=True)
    with open(base / "torch-ci-census.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not done.exists():
                results = run_all(CI, out_dir=str(out), verbose=False)
                with open(str(done) + ".tmp", "w") as f:
                    json.dump(results, f)
                os.replace(str(done) + ".tmp", done)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    with open(done) as f:
        return root, out, json.load(f)
