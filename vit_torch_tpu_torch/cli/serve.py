"""Serve a bundle over HTTP: ``python -m vit_torch_tpu_torch.cli.serve
--bundle /tmp/bundle --port 8000``.

Pairs with ``cli/export.py``.  Runs on the CUDA device unless
``--device cpu`` is given.  See ``serving/server.py`` for the endpoint
contract and the micro-batching behavior.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--bundle", required=True, help="bundle directory "
                   "(manifest.json + weights.pt)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=None,
                   help="micro-batch cap (default: largest bucket)")
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="micro-batch window: how long the first request in "
                        "a batch waits for company")
    p.add_argument("--predict_timeout_s", type=float, default=120.0,
                   help="per-request inference deadline; a wedged device "
                        "dispatch turns into 504s")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = p.parse_args(argv)

    from vit_torch_tpu_torch.serving.server import BundleServer
    server = BundleServer(args.bundle, host=args.host, port=args.port,
                          max_batch=args.max_batch,
                          max_wait_ms=args.max_wait_ms,
                          predict_timeout_s=args.predict_timeout_s,
                          device=args.device)
    host, port = server.address
    print(f"serving classifier bundle {args.bundle} on {args.device} at "
          f"http://{host}:{port} (buckets {list(server.model.batch_sizes)}, "
          f"POST /v1/predict, GET /healthz)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
