"""Training of the port: losses, optimizers, the GAN step and the state it
runs on (counterpart of vits_tpu/train/)."""
