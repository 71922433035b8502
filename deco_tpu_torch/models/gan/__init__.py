"""The VAE-GAN's discriminator and losses (``deco_tpu/models/gan``)."""
