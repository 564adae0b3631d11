"""Demonstration runs of the port (counterparts of the JAX package's
``scripts/``), each runnable as
``python -m stylerenderer_tpu_torch.scripts.<name> [--device cpu] ...``:

- ``train_demo``: the synth dataset at 64 px, ``cli.train`` in bf16, a
  random-backbone FID trend over the kept checkpoints;
- ``train_demo256``: 256 px, B=16 training, sustained images/s;
- ``train_demo256_ada``: ADA at 256 px, resumed from ``train_demo256``'s
  checkpoint where one exists; the controller's ``p`` and ``r_t``;
- ``recon_demo``: render inverting against targets with known ground
  truth (pixel MSE, PSNR, landmark error, vertex RMSE, seconds a face);
- ``recon_demo256``: the Regressor trained on ``train_demo256``'s
  checkpoint, then inversion under {mean-latent, Regressor} init x {short,
  full} iterations;
- ``parity_eval``: the published FID Inception and LPIPS VGG weights
  audited and loaded, then FID, PPL and LPIPS by the reference protocols
  (``--dry_run``: seeded stand-ins of the published layouts).

Each writes only under its ``--out`` (default ``torch_demos/<name>/`` in
the checkout), takes ``--device`` (default ``cuda``, never a fallback) and
returns a summary dict from ``main(argv)``.
"""
