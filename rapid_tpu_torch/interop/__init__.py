"""Reference-wire interop (port of ``rapid_tpu/interop``): protobuf
schema/conversions (protobuf-only) and the gRPC transport (needs grpcio —
imported lazily so the conversion paths work without it). Host code with
no device path."""


def __getattr__(name):
    if name in ("GrpcClient", "GrpcServer"):
        from rapid_tpu_torch.interop import grpc_transport

        return getattr(grpc_transport, name)
    raise AttributeError(f"module 'rapid_tpu_torch.interop' has no attribute {name!r}")


__all__ = ["GrpcClient", "GrpcServer"]
