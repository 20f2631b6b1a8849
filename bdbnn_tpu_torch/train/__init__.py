"""Training: ``config`` (RunConfig), ``optim`` (optimizer policy),
``state`` (StepConfig, TrainState), ``step`` (train and eval steps),
``loop`` (``fit``) and ``ede`` (the EDE schedule).

Nothing is re-exported here: :mod:`bdbnn_tpu_torch.nn.binarize` imports
:mod:`bdbnn_tpu_torch.train.ede`, and the step and loop modules import
the layers, so importing them from this package would be circular.
"""
