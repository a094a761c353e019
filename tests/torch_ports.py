"""A free TCP port for a test world's rendezvous (``MASTER_PORT``).

Asking the kernel for port 0 hands out a port from its ephemeral range
(32768-60999 on Linux by default), the range every client socket draws
from: between the pick and the rank-0 store's listen, seconds later in a
fresh process, a client socket of a concurrent gloo world (each rank
connects to each peer) can take it, and the store fails with
EADDRINUSE. A random port below that range is never handed to a client
socket; one that binds now is free."""

import random
import socket

_RNG = random.SystemRandom()


def free_port(lo: int = 20000, hi: int = 32000) -> int:
    for _ in range(200):
        port = _RNG.randrange(lo, hi)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError(f"no free port in [{lo}, {hi})")
