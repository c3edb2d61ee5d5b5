"""Multi-device schedules (port of gemini_seal_tpu/parallel/): per-rank
bodies over a group of ranks (comm.py), threads of one process or
torch.distributed processes."""
