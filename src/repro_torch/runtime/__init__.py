"""Distribution substrate of the port: the serve mesh (``runtime/mesh.py``:
``MeshSpec``, ``DeviceMesh``, ``serve_mesh``), the serve path's
tensor-parallel rules and placements (``runtime/sharding.py``), elastic
planning (``runtime/elastic.py``) and int8 error-feedback gradient
compression (``runtime/compression.py``)."""
