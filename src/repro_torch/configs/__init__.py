# Architecture configs: the reference's plain-data config files, copied
# (base.py dataclasses, one file per arch, registry.py by name).
