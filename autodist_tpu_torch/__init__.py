"""autodist_tpu_torch: the PyTorch/CUDA port of ``autodist_tpu``.

Carries the synchronous AllReduce training step end to end on an NVIDIA
Hopper GPU::

    ad = AutoDist(resource_spec=spec, strategy_builder=AllReduce())
    sess = ad.distribute(loss_fn, params, optim.adamw(3e-4))
    metrics = sess.run(batch)

The package imports ``torch`` and never JAX or ``autodist_tpu``; entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
