"""Data-preparation and maintenance tools (counterparts of vits_tpu/toolkits/)."""
