"""Sharded registration over ``torch.distributed`` ranks
(``dist_icp.py``) and the launcher-environment helpers
(``multihost.py``)."""
