"""BLS12-381 batch signature verification on an NVIDIA GPU (PyTorch/CUDA).

Layers (bottom-up), mirroring lighthouse_tpu/crypto/bls:

  constants.py         curve parameters (single source of truth)
  fields_ref.py        pure-Python field towers      (host oracle)
  curve_ref.py         pure-Python group law + serde (host oracle)
  hash_to_curve_ref.py RFC 9380 expand_message_xmd + host hash_to_g2
  pairing_ref.py       pure-Python optimal-ate       (host oracle)
  aggregation.py       distinct-message grouping (the mega-pairing plan)
  gpu/                 limbs, kernels, tower, curve, hash_to_curve, pairing
  backends/            torch_cuda (the staged batch verifier) | cpu | fake |
                       fallback (torch_cuda degrading to cpu)
  pipeline.py          futures + the depth-2 double buffer
  scheduler.py         deadline-aware continuous batching over five lanes
  api.py               PublicKey/Signature/SignatureSet/verify_signature_sets,
                       verify_signature_sets_async
"""
