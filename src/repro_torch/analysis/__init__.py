"""Analysis for the port: ``perfmodel``, the Appendix-F performance model
(pure Python), whose ``buildup_ratio_model`` the fault harness checks the
measured gradient build-up against and whose ``overlap_report``
``obs.tracing.measured_bucket_timeline`` sets beside its measured buckets;
``report``, the residue-codec table (``python -m
repro_torch.analysis.report --codecs``)."""

from repro_torch.analysis import perfmodel

__all__ = ["perfmodel"]
