"""The benchmark's plain reference: a frozen NumPy copy of the Spiral client
(keys, queries, decoding) and the judge that decodes each answer with the
client's secret key and compares it with the row the benchmark wrote.

Nothing here imports torch, jax, sdk_tpu or sdk_tpu_torch.
"""
