"""Distribution substrate of the port: ``MeshSpec`` and elastic planning
(``runtime/elastic.py``) and int8 error-feedback gradient compression
(``runtime/compression.py``).  Mesh construction and sharding rules come
with tensor-parallel serving (``ROADMAP.md`` Queue 1 item 8)."""
