"""The repository's operational scripts on the port, one module for each
script of ``scripts/`` that the port serves, run as
``python -m dasa_tpu_torch.scripts.<name>``:

- ``make_task`` — a synthetic R2R-format task over connectivity graphs;
- ``make_mini_dataset`` — a one-scan slice of a task and its feature stores;
- ``random_agent`` / ``interactive_agent`` — walk the graph simulator with a
  seeded random policy or by hand;
- ``plot_curves`` — loss / error / success plots from a run's logs
  (needs matplotlib);
- ``make_aug_paths`` — sample new paths and caption them with a speaker
  into an ``R2R_aug``-style file for ``--aug``;
- ``check_real_data`` — the one-command readiness check: assets, features,
  checkpoint, argmax validation and SR/SPL per split;
- ``stream_quality_ab`` — stream against episodic training at matched
  agent-step counts.

Each takes the flags of its counterpart in ``scripts/`` and writes the same
files; the ones that build a model run on CUDA unless told ``--device
cpu``.
"""
