"""Scaling-efficiency harness: grid-points/s at 1 device vs an N-device
mesh (the BASELINE north-star "scaling efficiency" metric).

Without an accelerator it runs on N virtual CPU devices
(--xla_force_host_platform_device_count); on a multi-GPU host the same
code measures scaling over the cards — `make_mesh` lays the ('y','x')
mesh over whatever `jax.devices()` reports.

    python tools/scaling.py [-n 8] [--size 1024] [-H 7] [--iters 5]

Prints one JSON line: single-device and mesh throughput plus efficiency
(throughput_N / (N * throughput_1)). Weak-scaling mode (--weak) grows the
grid with the device count instead (efficiency = throughput_N /
(N * throughput_1) with per-device problem size held constant).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-n", type=int, default=8, dest="n_devices")
    parser.add_argument("--size", type=int, default=1024,
                        help="grid side length (strong scaling)")
    parser.add_argument("-H", "--halfwidth", type=int, default=7)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--weak", action="store_true",
                        help="grow the grid area with the device count")
    args = parser.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.n_devices}")

    import numpy as np
    import jax
    import jax.numpy as jnp
    if jax.device_count() < args.n_devices:
        print(f"need {args.n_devices} devices, have {jax.device_count()}",
              file=sys.stderr)
        return 1

    import gridpp_tpu as gridpp  # noqa: F401  (enum values)
    from gridpp_tpu.constants import Statistic
    from gridpp_tpu.ops import neighbourhood as nops
    from gridpp_tpu.parallel import make_mesh, sharded_neighbourhood

    n = args.size
    if args.weak:
        # per-device area constant: scale rows by the device count
        n_rows = n * args.n_devices
    else:
        n_rows = n
    rng = np.random.default_rng(0)
    x = rng.random((n_rows, n), np.float32)

    def timeit(fn, arr):
        fn(arr).block_until_ready()  # compile
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = fn(arr)
        out.block_until_ready()
        return arr.size * args.iters / (time.perf_counter() - t0)

    # single device
    dev0 = jax.devices()[0]
    single = jax.jit(
        lambda a: nops.neighbourhood(a, args.halfwidth,
                                     int(Statistic.Mean)),
        device=dev0)
    x1 = x if args.weak is False else x[: x.shape[0] // args.n_devices]
    rate_1 = timeit(single, jax.device_put(x1, dev0))

    # full mesh
    mesh = make_mesh(args.n_devices)
    fn = sharded_neighbourhood(mesh, args.halfwidth, int(Statistic.Mean))
    from jax.sharding import NamedSharding, PartitionSpec as P
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("y", "x")))
    rate_n = timeit(fn, xs)

    eff = rate_n / (args.n_devices * rate_1)
    print(json.dumps({
        "metric": "neighbourhood_scaling_efficiency",
        "mode": "weak" if args.weak else "strong",
        "devices": args.n_devices,
        "platform": jax.devices()[0].platform,
        "grid": [int(n_rows), int(n)],
        "gridpoints_per_s_1dev": rate_1,
        "gridpoints_per_s_mesh": rate_n,
        "efficiency": eff,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
