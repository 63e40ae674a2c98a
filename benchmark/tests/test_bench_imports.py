"""What the benchmark loads: every module of ``benchmark/run.py``, its
drivers, its readers and the entry points of the system under test that
the drivers call, and every module of ``benchmark/reference/``. Each
module's top-level name (the part before the first dot) is compared whole:
none may be JAX's or the JAX package's, and the reference loads nothing of
the system under test either."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark.lib import manifest

JAX = {"jax", "jaxlib", "flax", "content_aware_gan_compression_tpu"}
PORT = "content_aware_gan_compression_torch"


def top_level_names(code: str) -> set[str]:
    """The top-level names of ``sys.modules`` after ``code`` runs in a fresh
    interpreter at the checkout's root."""
    probe = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] " \
        "for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=manifest.ROOT, capture_output=True,
                         text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_drivers_and_readers():
    drivers = sorted({manifest.traffic(w["traffic"])["driver"]
                      for w in manifest.manifest()["workloads"]})
    metrics = [m["name"] for m in manifest.manifest()["per_layer"]]
    names = top_level_names(
        "import benchmark.run\n"
        "from benchmark.lib import manifest\n"
        f"for d in {drivers!r}: manifest.driver(d)\n"
        f"for m in {metrics!r}: manifest.reader(m)\n"
        f"import {PORT}.models, {PORT}.train, {PORT}.train.steps, "
        f"{PORT}.evaluation.fid, {PORT}.parallel\n"
        "import benchmark.control.faults, benchmark.control.readings\n")
    assert PORT in names and "benchmark" in names
    assert not names & JAX, names & JAX


def test_reference_loads_nothing_of_the_program():
    names = top_level_names("import benchmark.reference.ops, benchmark.reference.stylegan2, "
                            "benchmark.reference.aux_nets, benchmark.reference.train")
    assert "torch" in names
    assert not names & (JAX | {PORT}), names & (JAX | {PORT})


def test_forbidden_names_are_whole_top_level_names():
    """The port's name begins with the JAX package's stem; only whole
    top-level names count."""
    from benchmark import run

    assert set(run.FORBIDDEN) == JAX
    assert all(PORT.split(".")[0] != name for name in run.FORBIDDEN)
