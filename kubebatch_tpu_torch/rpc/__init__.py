"""The solver's wire: the solve path's messages (wire.py, in plain Python
and numpy, with the bytes protoc's classes write), the encode and replay
half of the client (client.py) and the solve half of the server
(server.py). Ref: kubebatch_tpu/rpc.

Not here yet: the grpc transport (the server, the client's channel, the
span graft) and the victim wire — ROADMAP A8. This package imports
neither grpc nor protobuf.
"""
from . import wire
from .client import apply_decisions, build_snapshot
from .server import decode_snapshot, fused_lane_args, solve_snapshot

__all__ = ["wire", "build_snapshot", "apply_decisions", "decode_snapshot",
           "fused_lane_args", "solve_snapshot"]
