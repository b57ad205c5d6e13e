"""``python -m repro_torch.telemetry [--require-metrics] trace.json [...]``

Artifact-validation CLI (same as ``repro_torch.telemetry.check.main``, but the
package entry point avoids runpy's found-in-sys.modules warning that
``python -m repro_torch.telemetry.check`` triggers — the package __init__
imports the check module).
"""

import sys

from repro_torch.telemetry.check import main

if __name__ == "__main__":
    sys.exit(main())
