"""CLI driver (reference src/client/Driver/Gridpp.cpp).

usage: gridpp_tpu inputs [options] outputs [options]
           [-v var [-d downscaler [opts]] [-c calibrator [opts]
            [-p parameters]]*]+ [--debug level] [--version]
"""
from __future__ import annotations

import sys
import time

from ..constants import __version__
from .file import File
from .setup import Setup

USAGE = """Post-processes gridded forecasts (gridpp on JAX).

usage:  gridpp_tpu inputs [options] outputs [options] [-v var [options]
            [-d downscaler [options]] [-c calibrator [options]
            [-p parameters [options]]]*]+ [--debug <level>]
        gridpp_tpu [--version]
        gridpp_tpu [--help]

Downscalers: nearestNeighbour bilinear gradient bypass upscale pressure smart
Calibrators: accumulate deaccumulate neighbourhood window qc qq threshold
             sort altitude override diagnoseWind diagnoseHumidity gaussian
             oi qnh phase windDirection mask regression
Parameters:  text format (header: time [lat lon elev] p1 p2 ...)
"""


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or "--help" in argv:
        print(USAGE)
        return 0
    if "--version" in argv:
        print(__version__)
        return 0
    debug_level = "warn"
    if "--debug" in argv:
        i = argv.index("--debug")
        debug_level = argv[i + 1]
        del argv[i:i + 2]

    setup = Setup(argv)
    if len(setup.input_names) != len(setup.output_names):
        raise RuntimeError(
            "Number of input files must equal number of output files")

    start = time.time()
    for in_name, out_name in zip(setup.input_names, setup.output_names):
        ifile = File.open(in_name, setup.input_options)
        ofile = ifile if in_name == out_name else File.open(
            out_name, setup.output_options)
        ofile.times = ifile.times
        ofile.num_ens = ifile.num_ens
        ofile.reference_time = ifile.reference_time

        written = []
        for vc in setup.variable_configurations:
            t0 = time.time()
            vc.downscaler.downscale(ifile, ofile)
            if debug_level == "info":
                print(f"Downscale {vc.variable}: {time.time() - t0:.2f}s")
            for calibrator, parfile in vc.calibrators:
                t0 = time.time()
                calibrator.calibrate(ofile, parfile)
                if debug_level == "info":
                    print(f"Calibrate {vc.variable} "
                          f"({type(calibrator).__name__}): "
                          f"{time.time() - t0:.2f}s")
            if vc.variable_options.get("write", True, bool):
                written.append(vc.variable)
        ofile.write(written, " ".join(["gridpp_tpu"] + argv))
    if debug_level in ("info", "warn"):
        print(f"Total time: {time.time() - start:.2f}s")
    return 0


def cli():
    """Console entry point: main() with JAX's persistent compilation cache
    in its fixed directory (gridpp_tpu.device.enable_compile_cache)."""
    from ..device import enable_compile_cache
    enable_compile_cache()
    return main()


if __name__ == "__main__":
    sys.exit(cli())
