"""Real-process control plane: root (HNP) → per-node daemons → workers.

This substrate runs the paper's deployment model (§3.2) with actual POSIX
processes on localhost: SIGKILL fault injection, SIGCHLD-equivalent child
monitoring, REINIT broadcast over TCP control channels, SIGUSR1 survivor
rollback, re-spawn, and an ORTE-style rejoin barrier. It exists to prove
the protocol outside simulation and to ground the simulator's constants.
"""
from .transport import send_msg, recv_msg, connect, listener
