"""The experiment drivers of the port: the runs that train the full model
for thousands of steps and give the port's evidence that it trains.

- `convergence`: the full model overfits 4 fixed synthetic rooms; corner-F1
  against the step (`scripts/convergence_tpu.py`).
- `fitted_mixture`: the gamma-mixture criterion, fitted against fixed, from
  one init (`scripts/fitted_mixture_tpu.py`).
- `semi_sup_ab`: the semi-supervised A/B on held-out rooms, from scratch
  and under the reference's fine-tune protocol (`scripts/semi_sup_ab.py`).
- `semi_sup_report`: renders the A/B's results (`scripts/semi_sup_report.py`).

Each runs as `python -m omni_pq_torch.experiments.<name>`, on the card
unless `--device cpu` is given, and writes only files named `*_torch`.
"""
