"""Keras-compatible frontend; counterpart of
``flexflow_tpu/frontends/keras/``.

Reference: python/flexflow/keras/ — Sequential/Model over a shared base
(keras/models/base_model.py), layer classes translating 1:1 onto FFModel
builder calls, optimizer/loss/metric name shims, callbacks. Same usage:

    from flexflow_tpu_torch.frontends import keras
    model = keras.Sequential([
        keras.layers.Conv2D(32, (3, 3), activation="relu",
                            input_shape=(3, 32, 32)),
        keras.layers.Flatten(),
        keras.layers.Dense(10, activation="softmax"),
    ])                     # Sequential(..., device="cpu") off the card
    model.compile(optimizer="sgd",
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.fit(x, y, epochs=5)
"""

from . import datasets, layers
from .callbacks import (Callback, EarlyStopping, EpochVerifyMetrics,
                        LearningRateScheduler, VerifyMetrics)
from .models import Model, Sequential
from .optimizers import SGD, Adam

__all__ = ["datasets", "layers", "Model", "Sequential", "SGD", "Adam",
           "Callback", "EarlyStopping", "EpochVerifyMetrics",
           "LearningRateScheduler", "VerifyMetrics"]
