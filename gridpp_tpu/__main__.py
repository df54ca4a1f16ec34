"""`python -m gridpp_tpu` runs the CLI client."""
import sys

from .client.driver import cli

sys.exit(cli())
