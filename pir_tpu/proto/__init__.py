"""Wire messages (payload.proto) and their protobuf-free codec (payload.py)."""
