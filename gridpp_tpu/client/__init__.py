"""Command-line client: NetCDF post-processing pipeline.

A re-design of the reference CLI (reference src/client/): the same
`gridpp inputs outputs -v var -d downscaler -c calibrator -p parameters`
command structure, but built directly on the library API
instead of a second operator hierarchy. NetCDF3 I/O via scipy; NetCDF4
files require the optional netCDF4 package.
"""
from .driver import main  # noqa: F401
