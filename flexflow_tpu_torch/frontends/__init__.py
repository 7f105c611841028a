"""Frontends of the port: the Keras-compatible API (``keras``), the
importer of real tf.keras models (``keras_exp``), the ONNX importer
(``onnx``, with the dependency-free wire reader ``onnx_wire``) and the
torch.fx importer (``torchfx``) — the counterparts of
``flexflow_tpu/frontends/``, emitting the port's ``FFModel`` graph
through the same builder calls (reference python/flexflow/{keras,onnx,
torch}).
"""
