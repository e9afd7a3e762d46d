"""Data-preparation tools of the SAT flow (counterparts of vits_tpu/toolkits/)."""
