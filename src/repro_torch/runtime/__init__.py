"""Distribution substrate of the port: ``MeshSpec`` and elastic planning
(``runtime/elastic.py``).  Mesh construction and sharding rules come with
tensor-parallel serving (``ROADMAP.md`` Queue 1 item 8)."""
