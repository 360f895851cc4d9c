"""Analysis for the port: ``perfmodel``, the Appendix-F performance model
(pure Python), whose ``buildup_ratio_model`` the fault harness checks the
measured gradient build-up against."""

from repro_torch.analysis import perfmodel

__all__ = ["perfmodel"]
