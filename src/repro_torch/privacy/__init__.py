"""Privacy and robustness toolkit of the port (``repro/privacy``): makes
the paper's claim that sharing public-set predictions preserves data
privacy executable.

  accountant  Renyi (epsilon, delta) accounting for the Gaussian-mechanism
              releases DP-DML makes every mutual epoch.
  dp          the clip + Gaussian-noise payload transforms applied to
              shared predictions BEFORE they cross client boundaries, and
              ``gaussian``, the port's one source of DP noise.
  attacks     the probes: loss-threshold / surrogate membership inference
              and gradient-inversion reconstruction, against DML
              prediction payloads and FedAvg weight uploads.

The strategies that consume it live in ``repro_torch.core.strategies``
(``DPDML``, ``TrimmedDML``, ``MedianDML``).
"""
from repro_torch.privacy.accountant import (RDPAccountant, calibrate_noise,
                                            gaussian_epsilon)
from repro_torch.privacy.attacks import (cosine_similarity, dense_features,
                                         example_gradient,
                                         features_from_grad,
                                         gradient_inversion, mia_advantage,
                                         payload_mia, payload_reconstruction,
                                         reconstruction_error,
                                         weight_upload_mia)
from repro_torch.privacy.dp import DPSpec, clip_payload, dp_noise_payload

__all__ = [
    "RDPAccountant", "gaussian_epsilon", "calibrate_noise",
    "DPSpec", "clip_payload", "dp_noise_payload",
    "mia_advantage", "weight_upload_mia", "payload_mia",
    "example_gradient", "dense_features", "features_from_grad",
    "cosine_similarity",
    "gradient_inversion", "payload_reconstruction", "reconstruction_error",
]
