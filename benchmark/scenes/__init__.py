"""Scene builders of the benchmark's configurations, one module each,
found by the name a configuration file gives under "scene".

A builder is a frozen copy of the port's scene code, so that a change to
the port's ``models/`` does not move the benchmark's inputs. It computes
every number itself (meshes from the frozen ``reference`` geometry,
materials, instances, lights) and hands them to the scene types of the
side that renders them, through ``api`` (``benchmark.harness.scene_api``):
the port's public ``Scene`` types for the program, the reference's copies
for the reference. So both sides get the same inputs.

    build(api, models_dir) -> (scene, lights)

``models_dir`` is the directory of the mesh files (skull.txt, car.txt),
None for a scene that loads none.
"""
