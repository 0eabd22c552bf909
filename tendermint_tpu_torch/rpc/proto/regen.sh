#!/bin/sh
# Regenerate tmtpu_pb2.py from tmtpu.proto (no grpc_tools in the image;
# service stubs are hand-wired in grpc_service.py / abci/grpc_app.py).
cd "$(dirname "$0")" && protoc --python_out=. tmtpu.proto
