"""Layer modules and the functional cores they run (attention, MoE routing,
MLA, RG-LRU and SSD scans), each the counterpart of the reference's module
of the same name."""
