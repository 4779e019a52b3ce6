"""`python -m photon_ml_tpu_torch.analysis` == `python -m
photon_ml_tpu_torch.analysis.lint`."""
import sys

from photon_ml_tpu_torch.analysis.lint import main

if __name__ == "__main__":
    sys.exit(main())
