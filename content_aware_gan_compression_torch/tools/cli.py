"""One of the port's CLIs run as a user runs it: ``python -m
content_aware_gan_compression_torch.<module> ...`` in a subprocess, or its
``main(argv)`` in this process (``in_process``: one interpreter for a quick
check). Either way its standard output is returned and kept in a log file."""

from __future__ import annotations

import contextlib
import importlib
import io
import os
import subprocess
import sys
import time

PACKAGE = "content_aware_gan_compression_torch"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_cli(module, argv, log_path, *, in_process=False, timeout=None):
    """Runs ``module`` with ``argv``; returns (its standard output, seconds).
    A CLI that fails raises: a subprocess's exit code with the end of its
    standard error, or the CLI's own exception in process."""
    argv = [str(a) for a in argv]
    print(f"# {module} {' '.join(argv)}", flush=True)
    t0 = time.time()
    if in_process:
        import torch

        if torch.cuda.is_initialized():  # each CLI reads its own peak, as a process would
            torch.cuda.reset_peak_memory_stats()
        mod = importlib.import_module(f"{PACKAGE}.{module}")
        main = getattr(mod, "main", None) or importlib.import_module(
            f"{PACKAGE}.{module}.__main__").main
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                main(argv)
        finally:
            text = out.getvalue()
            with open(log_path, "w") as f:
                f.write(text)
        return text, time.time() - t0
    proc = subprocess.run([sys.executable, "-m", f"{PACKAGE}.{module}", *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)
    with open(log_path, "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{module} exited with {proc.returncode} (log {log_path}):\n"
                           f"{proc.stderr[-3000:]}")
    return proc.stdout, time.time() - t0


def line_after(text, prefix):
    """The rest of the first line of ``text`` that starts with ``prefix``;
    raises when there is none."""
    for line in text.splitlines():
        if line.startswith(prefix):
            return line[len(prefix):].strip()
    raise RuntimeError(f"no line starting with {prefix!r} in:\n{text[-2000:]}")
