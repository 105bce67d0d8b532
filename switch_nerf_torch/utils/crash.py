"""Entry-point crash discipline: the torchelastic ``@record`` analog.

Port of ``switch_nerf_tpu/utils/crash.py``:

  * ``record(fn)``: on an uncaught exception, writes a JSON crash report
    (timestamp, host, pid, argv, exception, full traceback) to
    $SWITCH_NERF_ERROR_FILE (or $TORCHELASTIC_ERROR_FILE, else
    ./switch_nerf_error_<pid>.json) and re-raises, so the process exits
    non-zero.
  * ``install_faulthandler()``: faulthandler.enable() on stderr plus a
    SIGUSR1 all-thread stack dump.
  * ``cli_entry(fn, parser=...)``: ``record`` for a CLI main, which also
    parses the command line (``--help`` exits there, before any process
    group), joins the process group ``torchrun`` describes
    (``parallel.init_distributed``; a group of one process is none) and
    destroys it on the way out.
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


def cli_entry(fn=None, *, parser=None):
    """The shared CLI-main wrapper: ``record``, and the process group
    around ``fn(hparams, device)``.

    With ``parser`` (a parser factory) a call without hparams parses
    ``sys.argv`` first. Then ``parallel.init_distributed`` joins the group
    torchrun describes, over NCCL on a card and gloo with
    ``device="cpu"``, with a one-day timeout under --set_timeout (the
    reference's, for long Block-NeRF evals); a group the caller made is
    used as it is. ``--help`` starts no group."""
    if fn is None:
        return lambda f: cli_entry(f, parser=parser)

    @record
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        from switch_nerf_torch import parallel
        if parser is not None and not args and kwargs.get("hparams") is None:
            from switch_nerf_torch.config import parse_args
            kwargs["hparams"] = parse_args(parser())
        hparams = args[0] if args else kwargs.get("hparams")
        device = args[1] if len(args) > 1 else kwargs.get("device")
        created = False
        if not {"-h", "--help"}.intersection(sys.argv[1:]):
            created = parallel.init_distributed(
                device,
                timeout=(datetime.timedelta(days=1)
                         if getattr(hparams, "set_timeout", False) else None))
        try:
            return fn(*args, **kwargs)
        finally:
            if created:
                parallel.destroy()
    return wrapper
