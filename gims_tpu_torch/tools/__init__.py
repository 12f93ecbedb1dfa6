"""The port's counterparts of ``gims_tpu/tools``: the AGC parameter sweep, its
reports and the image-folder viewer."""
