from .fused import (eu_residual_obj, kl_h_update, kl_obj, kl_ratio,
                    kl_ratio_and_obj, kl_w_update)

__all__ = ["eu_residual_obj", "kl_h_update", "kl_obj", "kl_ratio",
           "kl_ratio_and_obj", "kl_w_update"]
