"""Entry-point crash discipline: the torchelastic ``@record`` analog.

Port of ``switch_nerf_tpu/utils/crash.py``:

  * ``record(fn)``: on an uncaught exception, writes a JSON crash report
    (timestamp, host, pid, argv, exception, full traceback) to
    $SWITCH_NERF_ERROR_FILE (or $TORCHELASTIC_ERROR_FILE, else
    ./switch_nerf_error_<pid>.json) and re-raises, so the process exits
    non-zero.
  * ``install_faulthandler()``: faulthandler.enable() on stderr plus a
    SIGUSR1 all-thread stack dump.
  * ``cli_entry(fn)``: ``record`` for a CLI main. The JAX package's also
    bootstraps its multi-host runtime; the port runs one process (its
    multi-process support is ROADMAP Queue A item 8).
"""
from __future__ import annotations

import datetime
import functools
import json
import os
import socket
import sys
import traceback


def _error_file_path() -> str:
    return (os.environ.get("SWITCH_NERF_ERROR_FILE")
            or os.environ.get("TORCHELASTIC_ERROR_FILE")
            or os.path.join(os.getcwd(),
                            f"switch_nerf_error_{os.getpid()}.json"))


def install_faulthandler() -> None:
    import faulthandler
    import signal
    try:
        faulthandler.enable(all_threads=True)
        if hasattr(signal, "SIGUSR1"):
            faulthandler.register(signal.SIGUSR1, all_threads=True,
                                  chain=True)
    except (ValueError, AttributeError, OSError):
        # non-main thread / no usable stderr (embedded use): best-effort
        pass


def record(fn):
    """Decorator for CLI main(): structured crash report + nonzero exit."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        install_faulthandler()
        try:
            return fn(*args, **kwargs)
        except SystemExit:
            raise                      # argparse exits carry their own code
        except BaseException as e:     # noqa: BLE001 — re-raised below
            report = {
                "timestamp": datetime.datetime.now(
                    datetime.timezone.utc).isoformat(),
                "hostname": socket.gethostname(),
                "pid": os.getpid(),
                "process_index": os.environ.get("RANK"),
                "argv": sys.argv,
                "entrypoint": getattr(fn, "__module__", "?"),
                "exc_type": type(e).__name__,
                "message": str(e),
                "traceback": traceback.format_exc(),
            }
            path = _error_file_path()
            try:
                with open(path, "w") as f:
                    json.dump(report, f, indent=1)
                print(f"[switch_nerf_torch] crash report written to {path}",
                      file=sys.stderr)
            except OSError:
                print("[switch_nerf_torch] failed to write crash report:",
                      file=sys.stderr)
                traceback.print_exc()
            raise
    return wrapper


def cli_entry(fn):
    """The shared CLI-main wrapper (``record``)."""
    return record(fn)
