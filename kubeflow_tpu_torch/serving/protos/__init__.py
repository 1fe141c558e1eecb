"""protoc-generated Open Inference Protocol messages (inference.proto),
for serving/grpc_server.py. Importing `inference_pb2` needs the
`protobuf` package; nothing imports it until a gRPC server or client is
made."""
