"""The tiered store's plumbing the training loop uses (port of
photon_ml_tpu/store/): errors, the retry discipline and the accounting
(base.py), and the training tenant's evictable coordinate blocks
(handles.py).  The row tables, serving tiers and the mesh staging registry
wait for ROADMAP.md queue A items 22 and 20."""
