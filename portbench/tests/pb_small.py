"""A tiny PQ-Transformer for the benchmark's CPU tests: the published
layout at smoke widths (the CLIs' --smoke model) on 1024-point rooms."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL = dict(num_proposal=16, num_quad_proposal=16, num_decoder_layers=2,
             hidden_dim=32, nhead=4, dim_feedforward=64, backbone_width=1,
             backbone_npoints=[128, 64, 32, 16],
             backbone_nsamples=[16, 16, 16, 16], vote_aggregation_nsample=16,
             num_points=1024)
SEED = 2 ** 31 + 11  # a seed wider than 32 signed bits
