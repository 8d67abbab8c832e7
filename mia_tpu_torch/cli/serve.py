"""``mia-torch-serve``: the port's resident scoring server.

Holds the card, its CUDA context and the built kernel library, so that
short ``mia`` runs score without importing torch (see
:mod:`mia_tpu_torch.serve`).  Point runs at it with ``MIA_TORCH_SERVER``
(a path, or ``auto`` for the default socket).  Runs on the card, or on the
CPU only when ``MIA_TORCH_DEVICE=cpu`` asks for it.  SIGTERM and SIGINT
stop it and remove its socket.

    python -m mia_tpu_torch.cli.serve [--sock PATH] [--idle-timeout SECONDS]
"""
from __future__ import annotations

import signal
import sys


def _stop(signum, frame) -> None:
    raise SystemExit(0)


def main(argv=None) -> int:
    import argparse

    from ..serve import Server, sock_path

    p = argparse.ArgumentParser(prog="mia-torch-serve")
    p.add_argument("--sock", default=None, help=f"unix socket (default {sock_path()})")
    p.add_argument("--idle-timeout", type=float, default=0.0,
                   help="exit after this many idle seconds (0 = run until stopped)")
    args = p.parse_args(argv)
    signal.signal(signal.SIGTERM, _stop)
    Server(args.sock, idle_timeout=args.idle_timeout).serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
