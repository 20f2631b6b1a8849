"""The port's counterparts of the reference's root scripts, each run as
``python -m bdbnn_tpu_torch.scripts.<name>`` on the card:

- ``bench`` — the flagship train step's images/s as one JSON line
  (``bench.py``);
- ``profile_step`` — that step's profile: device ms by kernel name and by
  category, into ``PROFILE.json`` (``profile_r05.py``);
- ``bench_kernels`` — K1 at the binary conv shapes of ImageNet ResNet-18
  in f32 and bf16 (``bench_kernels.py``);
- ``bench_pipeline`` — the image-folder input pipelines' images/s by
  threads and worker processes (``bench_pipeline.py``).
"""
