from .engine import ServeEngine, Request
from .replicate import ServeReplicator
from .cluster import Arrival, LoadGen, RankKilled, ServeCluster, TokenSink

__all__ = ["ServeEngine", "Request", "ServeReplicator", "Arrival",
           "LoadGen", "RankKilled", "ServeCluster", "TokenSink"]
