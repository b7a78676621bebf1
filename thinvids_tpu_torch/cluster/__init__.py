"""Cluster layer of the port: so far the live part of the job executor
(:mod:`.executor`: tail a growing source, encode it GOP by GOP on the
card, package LL-HLS as it goes). The coordinator, the job store and the
remote backend are not ported yet; a caller drives :func:`run_live`
directly and receives the coordinator calls it makes through a hooks
object."""

from .executor import HaltedError, LiveHooks, run_live

__all__ = ["HaltedError", "LiveHooks", "run_live"]
