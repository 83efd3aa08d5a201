"""Several test processes share the host: each takes half its cores."""
import os

import torch

torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
