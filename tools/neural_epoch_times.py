#!/usr/bin/env python3
"""The neural methods' fit times per epoch on one NVIDIA card, at the
reference's size and a few epochs: what `chip_smoke.py`'s `NEURAL_E` is set
from.

    python3 tools/neural_epoch_times.py

Runs `chip_smoke.run_sweep` (seed 0, 1,000 / 100 / 100 patients, f32, the
JAX package's config defaults) for crn, rmsn and edct at 2 epochs and gnet
at 10, on EQ_4_D and cancer_sim, printing each run's stages and each
network's fit with its batches per second; then rmsn, gnet and edct f32 on
the card against f32 on the host (`chip_smoke.check_neural_card_against_
host`). A fit's seconds over its epochs is the time an epoch takes; the
first fit of the process also pays the card's warm-up.
"""

import os
import subprocess
import sys

# the repository root in place of tools/ (whose queue.py would shadow the
# standard library's)
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EPOCHS = {'crn': 2, 'rmsn': 2, 'edct': 2, 'gnet': 10}


def main():
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit('neural_epoch_times: needs an NVIDIA card')
    dev = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), torch.__version__,
          torch.version.cuda, flush=True)
    cs.run_sweep(dev, cs.NEURAL_DATASETS, 'epoch-times', tuple(EPOCHS),
                 model_overrides={m: {'epochs': e}
                                  for m, e in EPOCHS.items()})
    cs.check_neural_card_against_host(dev, cs.NEURAL_6B_METHODS)


if __name__ == '__main__':
    main()
